"""The port's repo-invariant lint (``repro_torch.analysis.lint``) vs the
reference's (``repro.analysis.lint``).

The five rules are the reference's: on the reference's own test sources
both linters give the same findings (rule, line, message).  The port's
``kernel-guard`` also holds the f64 instances of the join kernels
(``cutjoin_reduce_f64``, ``cutjoin_reduce_keep_f64``) to a guard, which
``cutjoin_exact_f64`` or lowering's ``_f64_admits`` satisfies.  The
lint runs clean over ``src/repro_torch``, its default path.
"""
from pathlib import Path

import pytest

import repro_torch
from repro_torch.analysis import lint as tlint

from test_torch_reference import reference  # noqa: F401

PORT = Path(next(iter(repro_torch.__path__)))

# the sources of the reference's lint tests (tests/test_analysis.py)
SOURCES = {
    "time-time": "import time\nt0 = time.time()\n",
    "time-time-waived":
        "import time\nt0 = time.time()  # lint: allow=no-time-time\n",
    "perf-counter": "import time\nt0 = time.perf_counter()\n",
    "mutable-list": "def f(x, acc=[]):\n    return acc\n",
    "mutable-dict": "def f(*, memo=dict()):\n    return memo\n",
    "immutable": "def f(x, acc=None, k=()):\n    return acc\n",
    "kernel-unguarded": ("from repro.kernels import ops\n"
                         "def join(Ms):\n"
                         "    return ops.cutjoin_reduce(Ms, bm=128, "
                         "bn=128)\n"),
    "kernel-guarded": ("from repro.kernels import ops\n"
                       "def join(Ms):\n"
                       "    block = ops.cutjoin_exact_block(Ms)\n"
                       "    if block is None:\n"
                       "        return None\n"
                       "    return ops.cutjoin_reduce(Ms, bm=block, "
                       "bn=block)\n"),
    "kernel-class-guard": ("from repro.kernels import ops\n"
                           "class P:\n"
                           "    def guard(self, Ms):\n"
                           "        return ops.cutjoin_exact_block(Ms)\n"
                           "    def join(self, Ms):\n"
                           "        b = self.guard(Ms)\n"
                           "        return ops.cutjoin_reduce(Ms, bm=b, "
                           "bn=b)\n"),
    "ir-incomplete": ("from dataclasses import dataclass\n"
                      "@dataclass(frozen=True)\n"
                      "class Op:\n"
                      "    key: str\n"
                      "    extra: int\n"
                      "    def refs(self):\n"
                      "        return ()\n"
                      "    def to_dict(self):\n"
                      "        return {'key': self.key}\n"
                      "def op_from_dict(d):\n"
                      "    return Op(d['key'], 0)\n"),
    "plain-dataclass": ("from dataclasses import dataclass\n"
                        "@dataclass\n"
                        "class Cfg:\n"
                        "    key: str\n"
                        "    extra: int\n"),
    "shard-map-unguarded": ("from jax import shard_map\n"
                            "def run(f, mesh):\n"
                            "    return shard_map(f, mesh=mesh)\n"),
    "shard-map-guarded": ("from jax import shard_map\n"
                          "def run(f, mesh):\n"
                          "    with meshes.sharding_ctx(mesh):\n"
                          "        return shard_map(f, mesh=mesh)\n"),
    "syntax-error": "def f(:\n",
}
WANT_RULES = {
    "time-time": ["no-time-time"], "time-time-waived": [],
    "perf-counter": [], "mutable-list": ["no-mutable-default"],
    "mutable-dict": ["no-mutable-default"], "immutable": [],
    "kernel-unguarded": ["kernel-guard"], "kernel-guarded": [],
    "kernel-class-guard": [],
    "ir-incomplete": ["ir-dict-complete", "ir-dict-complete"],
    "plain-dataclass": [], "shard-map-unguarded": ["mesh-guard"],
    "shard-map-guarded": [], "syntax-error": ["syntax"],
}


def _findings(lint, src):
    return [(f.rule, f.line, f.message)
            for f in lint.lint_source(src, "t.py")]


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_same_findings_as_the_reference(reference, case):
    from repro.analysis import lint as rlint
    got = _findings(tlint, SOURCES[case])
    assert got == _findings(rlint, SOURCES[case])
    assert sorted(rule for rule, _, _ in got) == WANT_RULES[case]


def test_rules_are_the_reference_rules(reference):
    from repro.analysis import lint as rlint
    assert tlint.RULES == rlint.RULES
    assert tlint._KERNEL_WRAPPERS - rlint._KERNEL_WRAPPERS == \
        {"cutjoin_reduce_f64", "cutjoin_reduce_keep_f64"}
    assert tlint._GUARD_CALLS - rlint._GUARD_CALLS == \
        {"cutjoin_exact_f64", "_f64_admits"}


@pytest.mark.parametrize("wrapper", ["cutjoin_reduce_f64",
                                     "cutjoin_reduce_keep_f64"])
@pytest.mark.parametrize("guard, caught", [
    (None, True),
    ("ops.cutjoin_exact_f64(maxes, cells)", False),
    ("self._f64_admits(Ms, maxes, cells)", False),
    ("ops.cutjoin_exact_block(Ms)", False),
], ids=["unguarded", "exact-f64", "f64-admits", "exact-block"])
def test_kernel_guard_holds_the_f64_instances(wrapper, guard, caught):
    """An f64 instance called with no guard in scope is a finding (the
    reference's lint does not know these names); any guard call of the
    set in an enclosing scope clears it."""
    body = (f"        if not {guard}:\n            return None\n"
            if guard else "")
    src = ("from repro_torch.kernels import ops\n"
           "class Plan:\n"
           "    def join(self, Ms, maxes, cells):\n"
           f"{body}"
           f"        return ops.{wrapper}(Ms)\n")
    got = _findings(tlint, src)
    if caught:
        assert [(rule, line) for rule, line, _ in got] == \
            [("kernel-guard", 4)]
        assert got[0][2].startswith(f"{wrapper}() called without")
    else:
        assert got == []
    waived = src.replace(f"ops.{wrapper}(Ms)",
                         f"ops.{wrapper}(Ms)  # lint: allow=kernel-guard")
    assert _findings(tlint, waived) == []


def test_lint_clean_over_src_repro_torch():
    """The gate as a test: the port lints clean, with the f64 instances
    under ``kernel-guard``; and the lowering calls them where the guard
    runs."""
    findings = tlint.lint_paths([PORT])
    assert findings == [], "\n".join(str(f) for f in findings)
    lowering = (PORT / "compiler" / "lowering.py").read_text()
    for name in ("cutjoin_reduce_f64(", "cutjoin_reduce_keep_f64(",
                 "_f64_admits("):
        assert name in lowering


def test_the_same_findings_over_both_packages(reference):
    """Each linter over each package's sources: the same findings where
    the rule sets agree (the reference's package has no f64 instance)."""
    import repro
    from repro.analysis import lint as rlint
    ref_pkg = Path(next(iter(repro.__path__)))
    for pkg in (PORT, ref_pkg):
        assert [str(f) for f in tlint.lint_paths([pkg])] == \
            [str(f) for f in rlint.lint_paths([pkg])]


def test_lint_cli_exit_codes(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nt0 = time.time()\n")
    assert tlint.main([str(bad)]) == 1
    assert "[no-time-time]" in capsys.readouterr().out
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert tlint.main([str(good)]) == 0
    assert tlint.main(["--list-rules"]) == 0
    assert capsys.readouterr().out.split() == list(tlint.RULES)
    # no path: the port's package, from the repository root
    monkeypatch.chdir(PORT.parent.parent)
    assert tlint.main([]) == 0
