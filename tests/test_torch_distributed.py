"""The port's multi-process MSM (tpu_msm_torch.parallel.distributed) on the
CPU: real OS processes of `python -m tpu_msm_torch.parallel.distributed`,
`--device cpu`, joined over gloo on a free localhost port, at --log-size 8
(the JAX package's tests/test_distributed.py shape) with 8-bit scalars
(`--scalar-bits`: the plain EC ops take about 20 ms a call on a CPU, so the
window count sets the time). Each rank prints the sha256 of the result's
bytes: the ranks' digests must be equal to each other and to the digest of
`parallel.sharded.msm_sharded` over as many shards in this process.
"""

import os
import re
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch.parallel import distributed, sharded  # noqa: E402
from tpu_msm_torch.utils import interop, oracle  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_SIZE, BITS, C, LANES = 8, 8, 4, 8
CFG = MsmConfig(window_bits=C, scan_lanes=LANES, scalar_bits=BITS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, collective: str, timeout: int = 240):
    """The digests the `world` ranks print, in rank order."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_msm_torch.parallel.distributed",
         "--init-method", init, "--world-size", str(world), "--rank", str(r),
         "--backend", "gloo", "--device", "cpu", "--log-size", str(LOG_SIZE),
         "--window-bits", str(C), "--scan-lanes", str(LANES),
         "--scalar-bits", str(BITS), "--collective", collective],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    digests = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        m = re.search(rf"proc {r}/{world} devices=cpu .*"
                      r"result_sha256=([0-9a-f]{64})", out)
        assert m, f"rank {r} printed no digest:\n{out}"
        digests.append(m.group(1))
    return digests


def _in_process(world: int, collective: str):
    px, py, sl = distributed.workload(LOG_SIZE, BITS)
    return sharded.msm_sharded((px, py), sl, devices=["cpu"] * world,
                               cfg=CFG, collective=collective)


@pytest.mark.parametrize("collective", sharded.COLLECTIVES)
def test_two_ranks_equal_one_process(collective):
    ranks = _run_ranks(2, collective)
    assert ranks[0] == ranks[1], "the ranks' results differ"
    assert ranks[0] == distributed.digest(*_in_process(2, collective)), \
        "two processes differ from two shards in one process"


def test_three_ranks_ppermute_tree_equal_the_oracle():
    """A world that is not a power of two: the binomial tree's last round
    has one pair."""
    ranks = _run_ranks(3, "ppermute_tree")
    assert len(set(ranks)) == 1
    res = _in_process(3, "ppermute_tree")
    assert distributed.digest(*res) == ranks[0]
    px, py, sl = distributed.workload(LOG_SIZE, BITS)
    want = oracle.msm(interop.limbs_to_ints(sl),
                      interop.limbs_to_affine_points(px, py))
    assert interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in res)) == [want]


def test_workload_cuts_scalars_to_their_low_bits():
    _, _, full = distributed.workload(LOG_SIZE)
    _, _, cut = distributed.workload(LOG_SIZE, 20)
    assert (cut[2:] == 0).all() and (cut[0] == full[0]).all()
    assert (cut[1] == full[1] & 0xF).all()


def test_rank_device_needs_a_card_unless_told():
    assert distributed.rank_device(3, "cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        assert distributed.rank_device(3) == torch.device("cuda", 3 % count)
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            distributed.rank_device(0)
