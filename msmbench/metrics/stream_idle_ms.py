"""stream_idle_ms: idle device ms a call while the host's innermost
program span is one of `tpu_msm_torch.streaming` (chunk, accumulate;
`msmbench/spans.py`): the host between the chunks."""

from msmbench.spans import stage_ms


def read(rec):
    return stage_ms(rec, ["tpu_msm_torch.streaming"], idle=True)
