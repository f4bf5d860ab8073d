"""sides_ms: device ms a call launched inside the span
`tpu_msm_torch.pippenger.sides` as the innermost program span
(`msmbench/spans.py`): the lane carries, the queries, the fold, the tree
and the window tail."""

from msmbench.spans import stage_ms


def read(rec):
    return stage_ms(rec, ["tpu_msm_torch.pippenger.sides"])
