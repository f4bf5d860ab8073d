"""The port's micro-benches (tpu_msm_torch/benches/{conversion,sort,msm}_
benchmark.py) against the JAX package on the same seeded inputs, on the CPU
(`--device cpu`), at small sizes.

* Conversion: at 2^10 each converter the bench times (the four of the root
  script and the C ABI path's three `from_h2c_bytes` calls) equals
  `tpu_msm.utils.interop`'s on the same bytes, exactly; `main` prints one
  JSON line a conversion.
* Sort (a): at 2^10 the port's `sort_by_key` against the root script's
  `jax.lax.sort([keys] + rows, num_keys=1)`. The keys are exactly equal.
  `lax.sort` is not stable unless asked (`is_stable=False`), so within each
  key the payload columns are compared as a multiset: both results are
  lexsorted by (key, payload rows) and must then be equal. The port's
  payload also equals the one gathered by the stable `np.argsort`.
* Sort (b): at G = 2 windows of 2^10 points and 128 lanes, the main path's
  `_sorted_scan_inputs` (on the bench's operands) against the JAX
  package's (`tpu_msm/ops/pippenger.py:271-307`, both `sort_impl`
  values), window by window. Layout mapping: the port's sgx, sgy are
  (G, 8, steps, lanes) int32 and its sorted digits (G, n_pad) int32; the
  JAX function takes one window and returns (8, steps, lanes / 128, 128)
  uint32 and (n_pad,) uint32, so window g's port block reshaped to (8,
  steps, lanes) holds the JAX block reshaped the same way, as u32 bit
  patterns. The JAX function takes (8, n_pad) x words and y words already
  negated where the digit is (ppy_w); the port takes `scan_operands`'
  point-major table, (n_pad, 16) [x | y] or (n_pad, 24) [x | y | -y], and
  the masks. 128 lanes are the least the JAX layout takes (lanes / 128 rows
  of 128).
* MSM: at `--log-size 8 --instances 2`, with TPU_MSM_CACHE_DIR on
  tmp_path, the instances equal the JAX package's
  `get_or_create_msm_instances(8, 2)` bit for bit, and the bench's CPU
  `msm_device` result equals `tpu_msm.bindings.native.msm` of instance 0.
* Each bench's default device is the card: without one its `main` raises.
  One `cuda` case each runs `main` on the card at a small size.

jax and the JAX package are imported inside fixtures only, so the `cuda`
cases also run where jax is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_benches.py
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch.benches import (conversion_benchmark,  # noqa: E402
                                   msm_benchmark, sort_benchmark)
from tpu_msm_torch.cli import trace  # noqa: E402
from tpu_msm_torch.ops import pippenger  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

BENCHES = {"conversion": conversion_benchmark, "sort": sort_benchmark,
           "msm": msm_benchmark}


@pytest.fixture(scope="module")
def jinterop():
    from tpu_msm.utils import interop as jinterop

    return jinterop


@pytest.fixture(scope="module")
def jax():
    import jax

    return jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The CPU MSM runs thousands of narrow plain EC ops; beside other test
    workers torch's intra-op threads only add contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.startswith("{")]


# --------------------------------------------------------------------------
# Conversion.
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def conversion_run():
    return conversion_benchmark.run(10, iters=1, device="cpu")


def _jax_conversions(jinterop, raw, limbs, points):
    n = limbs.shape[1]
    wire = conversion_benchmark.wire_arrays(raw, points)
    want = {
        "from_h2c_bytes": jinterop.from_h2c_bytes(
            np.frombuffer(raw, np.uint8).reshape(n, 32)),
        "to_h2c_bytes": jinterop.to_h2c_bytes(limbs),
        "to_ark_u32_limbs": jinterop.to_ark_u32_limbs(limbs),
        "from_ark_u32_limbs": jinterop.from_ark_u32_limbs(
            jinterop.to_ark_u32_limbs(limbs)),
    }
    for name, data in wire.items():
        want[f"from_h2c_bytes {name}"] = jinterop.from_h2c_bytes(data)
    want["msm_best_wire's three from_h2c_bytes"] = [
        want[f"from_h2c_bytes {name}"] for name in wire]
    return want


def test_conversion_inputs_are_the_jax_scripts():
    """The root script's inputs: RandomState(0), rng.bytes(32 n) read as
    (n, 16) little-endian u16 limbs."""
    n = 1 << 10
    raw, limbs, points = conversion_benchmark.inputs(n)
    rng = np.random.RandomState(0)
    want_raw = rng.bytes(32 * n)
    assert raw == want_raw
    want = np.frombuffer(want_raw, dtype="<u2").reshape(n, 16).T
    assert limbs.dtype == np.uint32 and limbs.flags.c_contiguous
    assert np.array_equal(limbs, want.astype(np.uint32))
    assert points == rng.bytes(64 * n)


@pytest.mark.parametrize("name", [
    "from_h2c_bytes", "to_h2c_bytes", "to_ark_u32_limbs",
    "from_ark_u32_limbs", "from_h2c_bytes scalars",
    "from_h2c_bytes points x", "from_h2c_bytes points y",
    "msm_best_wire's three from_h2c_bytes"])
def test_conversion_matches_jax(conversion_run, jinterop, name):
    _, out = conversion_run
    want = _jax_conversions(jinterop, out["raw"], out["limbs"],
                            out["points"])[name]
    got = out[name]
    for g, w in zip(*((got, want) if isinstance(got, list)
                      else ([got], [want]))):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_conversion_main_prints_a_line_a_conversion(capsys):
    assert conversion_benchmark.main(
        ["--log-size", "10", "--iters", "1", "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert [rec["conversion"] for rec in lines] == [
        "from_h2c_bytes", "to_h2c_bytes", "to_ark_u32_limbs",
        "from_ark_u32_limbs", "from_h2c_bytes scalars",
        "from_h2c_bytes points x", "from_h2c_bytes points y",
        "msm_best_wire's three from_h2c_bytes"]
    for rec in lines:
        assert {"bench", "n", "iters", "ms", "melem_per_s", "device",
                "card"} <= set(rec)
        assert rec["n"] == 1 << 10 and rec["device"] == "cpu"
        assert rec["card"] is None and rec["ms"] > 0
        if rec["conversion"].startswith("from_h2c_bytes "):
            assert {"contiguous_ms", "transpose_ms", "widen_ms"} <= set(rec)


# --------------------------------------------------------------------------
# Sort (a).
# --------------------------------------------------------------------------

def _columns_by_key(keys, payload):
    """The (1 + rows, n) columns (key, payload...) in lexicographic order."""
    cols = np.vstack([keys[None], payload])
    return cols[:, np.lexsort(cols[::-1])]


def test_payload_sort_matches_lax_sort(jax):
    import jax.numpy as jnp

    outputs = {}
    [rec] = sort_benchmark.payload_sort([10], repeats=1, device="cpu",
                                        outputs=outputs)
    assert rec["n"] == 1 << 10 and rec["payload_rows"] == 32
    (keys, payload), (got_keys, got_payload) = outputs[10]
    # The JAX script's draw at its first size: the key, then the payload.
    rng = np.random.RandomState(0)
    draw = lambda *shape: rng.randint(  # noqa: E731
        0, 1 << 16, size=shape, dtype=np.int64).astype(np.uint32)
    assert np.array_equal(keys, draw(1 << 10))
    assert np.array_equal(payload, draw(32, 1 << 10))

    d = jnp.asarray(keys)
    p = jnp.asarray(payload)
    ref = jax.lax.sort([d] + [p[i] for i in range(32)], num_keys=1)
    ref_keys = np.asarray(ref[0])
    ref_payload = np.stack([np.asarray(r) for r in ref[1:]])
    assert np.array_equal(got_keys, ref_keys)
    assert np.array_equal(_columns_by_key(got_keys, got_payload),
                          _columns_by_key(ref_keys, ref_payload))
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(got_keys, keys[order])
    assert np.array_equal(got_payload, payload[:, order])


# --------------------------------------------------------------------------
# Sort (b).
# --------------------------------------------------------------------------

@pytest.mark.parametrize("signed", [False, True])
def test_main_path_sort_matches_jax(jax, monkeypatch, signed):
    import jax.numpy as jnp
    from tpu_msm.ops import pippenger as jpippenger

    lanes, n, g = 128, 1 << 10, 2
    # Two windows a group: the budget for G = 2 at n_pad = n.
    monkeypatch.setattr(pippenger, "CPU_GROUP_BUDGET",
                        g * n * pippenger.GROUP_BYTES_PER_POINT)
    cfg = MsmConfig(window_bits=16, scan_lanes=lanes, signed_digits=signed)
    outputs = {}
    rec = sort_benchmark.main_path_sort(10, repeats=1, device="cpu", cfg=cfg,
                                        outputs=outputs)
    assert (rec["windows"], rec["n_pad"], rec["lanes"], rec["steps"]) == (
        g, n, lanes, n // lanes)
    digits, negm, rows, args_lanes = outputs["args"]
    steps = n // lanes
    assert (negm is not None) == signed and args_lanes == lanes
    assert rows.shape == (n, 24 if signed else 16)
    sorted_digits, sgx, sgy = outputs["result"]
    assert sgx.shape == sgy.shape == (g, 8, steps, lanes)
    u32 = lambda t: t.numpy().view(np.uint32)  # noqa: E731
    words = u32(rows).T  # (16 or 24, n): x, y, then -y
    for w in range(g):
        y = words[8:16]
        if signed:
            y = np.where(negm[w].numpy()[None, :], words[16:24], y)
        for impl in ("payload", "rank"):
            jd, jx, jy = jpippenger._sorted_scan_inputs(
                jnp.asarray(u32(digits[w])),
                jnp.asarray(np.ascontiguousarray(words[:8])),
                jnp.asarray(np.ascontiguousarray(y)), lanes, steps, impl)
            assert np.array_equal(u32(sorted_digits[w]), np.asarray(jd))
            assert np.array_equal(u32(sgx[w]),
                                  np.asarray(jx).reshape(8, steps, lanes))
            assert np.array_equal(u32(sgy[w]),
                                  np.asarray(jy).reshape(8, steps, lanes))


def test_main_path_sort_splits_a_trace_by_launching_op():
    """Part (b)'s split of a profiled call: each device event goes to the
    outermost op around the op (External id) or runtime call
    (correlation) that launched it, the digit sort's operator or the
    layout's; the call's run of names is then found in msm_device's
    trace."""
    def op(name, ts, dur, ext):
        return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts,
                "dur": dur, "args": {"External id": ext}}

    def dev(name, ts, dur, cat="kernel", **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}

    events = [
        op("tpu_msm_torch::digit_sort", 0, 100, 1),
        op("aten::empty", 10, 5, 2),
        op("aten::reshape", 120, 20, 3),
        op("tpu_msm_torch::scan_layout", 150, 80, 4),
        op("aten::empty", 160, 5, 5),
        # The layout kernel's launch: a runtime call inside the operator,
        # whose correlation the kernel carries (it is launched by ctypes,
        # with no External id of an aten op).
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 50, "dur": 2, "args": {"correlation": 77}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 200, "dur": 2, "args": {"correlation": 78}},
        dev("radix", 1000, 300, **{"External id": 2}),
        dev("Memset (Device)", 1300, 10, cat="gpu_memset", correlation=77),
        dev("copy", 1400, 40, **{"External id": 3}),
        dev("scan_layout_kernel", 1500, 500, correlation=78),
    ]
    parts = trace.launching_ops(events)
    assert [(p[0], p[3]) for p in parts] == [
        ("radix", "tpu_msm_torch::digit_sort"),
        ("Memset (Device)", "tpu_msm_torch::digit_sort"),
        ("copy", "aten::reshape"),
        ("scan_layout_kernel", "tpu_msm_torch::scan_layout")]
    assert sort_benchmark.split(parts) == pytest.approx(
        {"sort_ms": 0.31, "layout_ms": 0.5, "other_ms": 0.04})
    names = ["digits", "radix", "scan_layout_kernel", "radix",
             "Memset (Device)", "copy", "scan_layout_kernel", "scan"]
    assert sort_benchmark.find_run(names, [p[0] for p in parts]) == 3
    with pytest.raises(RuntimeError, match="not occur as a run"):
        sort_benchmark.find_run(names[:-2], [p[0] for p in parts])
    with pytest.raises(RuntimeError, match="no host op launched"):
        trace.launching_ops([dev("orphan", 0, 1, correlation=1)])


def test_torch_ops_splits_torch_kernels_by_op():
    """torch's own kernels of a trace by the outermost op that launched
    them, the largest first; the port's kernels and copies are left out,
    and the radix sort's three kernels are the port's in msm_device's run
    even where its last pass is another instance."""
    def op(name, ts, dur, ext):
        return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts,
                "dur": dur, "args": {"External id": ext}}

    def dev(name, ts, dur, cat="kernel", **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}

    events = [
        op("aten::cat", 0, 10, 1), op("aten::where", 20, 10, 2),
        op("aten::copy_", 21, 2, 3), op("aten::cat", 40, 10, 4),
        dev("CatArrayBatchedCopy", 100, 30, **{"External id": 1}),
        dev("elementwise_kernel", 200, 50, **{"External id": 3}),
        dev("Memcpy DtoD", 300, 70, cat="gpu_memcpy", **{"External id": 3}),
        dev("CatArrayBatchedCopy", 400, 40, **{"External id": 4}),
        dev("padd_kernel", 500, 90, **{"External id": 2}),
    ]
    by_op = trace.torch_ops(trace.launching_ops(events))
    assert list(by_op) == ["aten::cat", "aten::where"]
    assert by_op["aten::cat"] == [pytest.approx(0.07), 2]
    assert by_op["aten::where"] == [pytest.approx(0.05), 1]
    names = ["void radix_count_kernel(int)",
             "void radix_scatter_kernel<false, false, false>(int)"]
    run = ["void radix_count_kernel(int)",
           "void radix_scatter_kernel<false, false, true>(int)"]
    assert sort_benchmark.find_run(names, run) == 0


# --------------------------------------------------------------------------
# MSM.
# --------------------------------------------------------------------------

def test_msm_instances_match_jax(tmp_path, monkeypatch):
    from tpu_msm.utils import preprocess as jpreprocess

    from tpu_msm_torch.utils import preprocess

    monkeypatch.setenv("TPU_MSM_CACHE_DIR", str(tmp_path / "jax"))
    want = jpreprocess.get_or_create_msm_instances(8, 2)
    monkeypatch.setenv("TPU_MSM_CACHE_DIR", str(tmp_path / "port"))
    got = preprocess.get_or_create_msm_instances(8, 2)
    # The port also reads the JAX package's file as it wrote it.
    monkeypatch.setenv("TPU_MSM_CACHE_DIR", str(tmp_path / "jax"))
    loaded = preprocess.get_or_create_msm_instances(8, 2)
    assert len(got) == len(want) == len(loaded) == 2
    for a, b, c in zip(got, want, loaded):
        for field in ("px", "py", "scalars"):
            x, y, z = getattr(a, field), getattr(b, field), getattr(c, field)
            assert x.dtype == y.dtype == z.dtype
            assert np.array_equal(x, y) and np.array_equal(z, y)


def test_msm_bench_matches_jax_native_engine(tmp_path, monkeypatch, capsys):
    from tpu_msm.bindings import native as jnative

    from tpu_msm_torch.utils import preprocess

    monkeypatch.setenv("TPU_MSM_CACHE_DIR", str(tmp_path))
    assert msm_benchmark.main(["--log-size", "8", "--instances", "2",
                               "--device", "cpu"]) == 0
    device_row, cpu_row = _lines(capsys)
    inst = preprocess.get_or_create_msm_instances(8, 2)[0]
    want = jnative.msm(inst.px, inst.py, inst.scalars)
    assert device_row["row"] == "device" and device_row["equals_native"]
    assert device_row["result"] == [hex(want[0]), hex(want[1])]
    assert len(device_row["host_ms"]) == 2
    assert device_row["event_ms"] is None and device_row["card"] is None
    assert cpu_row["row"] == "cpu" and cpu_row["ms"] > 0
    assert cpu_row["device"] == "cpu" and cpu_row["card"] is None


# --------------------------------------------------------------------------
# The card.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BENCHES))
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BENCHES[name].main(["--log-size", "8"] if name != "sort"
                           else ["--log-sizes", "8", "--main-log-size", "8"])


CARD_ARGS = {
    "conversion": ["--log-size", "12", "--iters", "2"],
    "sort": ["--log-sizes", "12", "14", "--main-log-size", "14"],
    "msm": ["--log-size", "12", "--instances", "2"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BENCHES))
def test_bench_on_the_card(cuda, name, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPU_MSM_CACHE_DIR", str(tmp_path))
    assert BENCHES[name].main(CARD_ARGS[name]) == 0
    lines = _lines(capsys)
    assert lines and all(rec["card"] for rec in lines)
    # Every line but the native engine's is the card's.
    assert [rec["device"] == "cpu" for rec in lines] == [
        rec.get("row") == "cpu" for rec in lines]
    if name == "sort":
        [b] = [rec for rec in lines if rec["part"] == "b"]
        # The sort is the port's kernel: the call launches none of torch's.
        assert b["device_events"] > 0 and b["sort_ms"] > 0
        assert b["share_of_torch"] == 0
