"""entry_idle_ms: idle device ms a call while the host's innermost program
span is `tpu_msm_torch.msm_best`, its `zero_scan` or
`tpu_msm_torch.msm.readback` (`msmbench/spans.py`). The zero scan's span
holds the scan, its host sync and the filter; the readback's the result's
copy to the host and the affine conversion. `msm_best`'s own span is the
innermost one over the coercion and over every host step of the routes
below it that lies outside their stages' spans: `msm`'s configuration and
the inputs' placement, the loop over window groups in `msm_device`, and
`msm_streamed`'s steps between its chunk and accumulate spans. So the
metric holds the entry and the routes' host code between stages."""

from msmbench.spans import stage_ms


def read(rec):
    return stage_ms(rec, ["tpu_msm_torch.msm_best",
                          "tpu_msm_torch.msm.readback"],
                    idle=True)
