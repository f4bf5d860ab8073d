"""stream_ms: device ms a call launched inside a span of
`tpu_msm_torch.streaming` (chunk, accumulate) as the innermost program span
(`msmbench/spans.py`): the chunks' slices, padding and copies, and the
accumulates of their window sums."""

from msmbench.spans import stage_ms


def read(rec):
    return stage_ms(rec, ["tpu_msm_torch.streaming"])
