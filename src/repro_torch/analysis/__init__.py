"""Static analysis over the plan IR.

``verify``  — structural verifier + abstract interpreter: DAG/ref/output
              integrity, shape and tier-matrix legality, budget checks,
              and ``exact_block`` precertification (see
              ``analysis.verify``).
"""
from repro_torch.analysis.verify import (Diagnostic, GraphInfo,
                                         PlanVerifyError, VerifyResult,
                                         infer_shapes, precertify,
                                         refusal_flags, verify)

__all__ = ["Diagnostic", "GraphInfo", "PlanVerifyError", "VerifyResult",
           "infer_shapes", "precertify", "refusal_flags", "verify"]
