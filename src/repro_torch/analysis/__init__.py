"""Static analysis over the plan IR.

``verify``  — structural verifier + abstract interpreter: DAG/ref/output
              integrity, shape and tier-matrix legality, budget checks,
              and ``exact_block`` precertification (see
              ``analysis.verify``).  ``morph_check`` validates a
              committed morph identity on the pattern-lattice endpoints;
              ``shard_check`` flags plan / mesh pairings that waste the
              mesh.
``lint``    — AST-level repo-invariant lint with a CLI
              (``python -m repro_torch.analysis.lint``); imported lazily —
              the serving path never pays for it.
"""
from repro_torch.analysis.verify import (Diagnostic, GraphInfo,
                                         PlanVerifyError, VerifyResult,
                                         infer_shapes, morph_check,
                                         precertify, refusal_flags,
                                         shard_check, verify)

__all__ = ["Diagnostic", "GraphInfo", "PlanVerifyError", "VerifyResult",
           "infer_shapes", "morph_check", "precertify", "refusal_flags",
           "shard_check", "verify"]
