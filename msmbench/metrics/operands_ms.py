"""operands_ms: device ms a call launched inside the span
`tpu_msm_torch.pippenger.operands` as the innermost program span
(`msmbench/spans.py`): the digits, their recoding and the packed row table
the scan reads."""

from msmbench.spans import stage_ms


def read(rec):
    return stage_ms(rec, ["tpu_msm_torch.pippenger.operands"])
