"""The MSM over several shards (counterpart of `tpu_msm/parallel/`).

`sharded`: D shards on a list of devices in one process. `collectives`: the
EC sums across the ranks of a `torch.distributed` group. `distributed`: one
shard a process, the processes joined by `torch.distributed`.
"""
