"""groups_ms: device ms a call launched inside the spans
`tpu_msm_torch.pippenger.group` (one a window group) as the innermost
program span (`msmbench/spans.py`): the digit sort, the scan, the
histogram and the prefix gather."""

from msmbench.spans import stage_ms


def read(rec):
    return stage_ms(rec, ["tpu_msm_torch.pippenger.group"])
