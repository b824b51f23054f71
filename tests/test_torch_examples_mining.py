"""The port's examples (``examples_torch/``) that take longest on the
CPU, apart from ``test_torch_examples.py`` so that workers share them:
each runs in a subprocess with ``--device cpu`` and must exit 0."""
import pytest

from test_torch_examples import run_example


@pytest.mark.parametrize("name", ["existence_and_listing", "local_counts",
                                  "morphing"])
def test_example_runs(name):
    lines = run_example(name)
    if name == "existence_and_listing":
        assert "cross-check vs get_pattern_count: True" in lines
    if name == "morphing":
        assert "morph_check: ok = True" in lines
