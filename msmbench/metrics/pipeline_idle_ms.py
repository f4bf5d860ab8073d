"""pipeline_idle_ms: idle device ms a call while the host's innermost
program span is a stage of `tpu_msm_torch.pippenger` (operands, group,
sides, horner; `msmbench/spans.py`): the host between the pipeline's
launches."""

from msmbench.spans import stage_ms


def read(rec):
    return stage_ms(rec, ["tpu_msm_torch.pippenger"], idle=True)
