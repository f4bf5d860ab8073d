"""entry_ms: the mean host ms of a `msm_best` call over the mean of the
call it makes into the layer below (`msm_device`, or `msm_streamed` above
the stream threshold) on the same inputs, each timed with a synchronize,
in alternating pairs (host clock): the zero scan and its host sync, the
coercion and the affine readback."""


def read(rec):
    if not rec.entry_s or not rec.below_s:
        return None
    return 1e3 * (sum(rec.entry_s) / len(rec.entry_s)
                  - sum(rec.below_s) / len(rec.below_s))
