"""The port's module map, read from the sources with `ast` (imports neither
jax nor torch).

* Every `tpu_msm/**/*.py` has a same-path file in `tpu_msm_torch/`, or
  stands in FILE_EXCEPTIONS with its reason.
* Every root `benches/*.py` has a `tpu_msm_torch/benches/*.py`.
* Every public top-level `def`, `class` and CONSTANT of a JAX module (and
  of a root bench) exists in its counterpart, or stands in NAME_EXCEPTIONS
  with its reason: a rename (the port's name, which must exist) or a
  decision not to port it (None). An exception that is no longer needed
  fails, so the tables stay true.
* Every `tpu_msm_torch/**/*.py` and `chip_smoke.py` imports no `jax` and no
  `tpu_msm` module, at any depth of the file.

Each module is its own case.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "tpu_msm"
PORT = ROOT / "tpu_msm_torch"

# JAX modules with no same-path file in the port: path -> (the port's files
# that stand for it, or None; the reason).
FILE_EXCEPTIONS = {
    "ops/f15.py": (None, "the TPU's 15-bit-limb field core, a schedule for "
                   "the VPU lanes; the H100 has one field core, "
                   "csrc/bn254.cuh (ROADMAP: not ported, by decision)"),
    "ops/fmxu.py": (None, "the TPU's MXU-REDC field core, a schedule for the "
                    "matrix unit; the H100 has one field core, "
                    "csrc/bn254.cuh (ROADMAP: not ported, by decision)"),
    "ops/pallas_curve.py": (("ops/cuda_curve.py", "csrc/ec_kernels.cu",
                             "csrc/bn254.cuh"),
                            "the Pallas kernels: their Hopper counterparts "
                            "are the CUDA kernels in csrc/, wrapped in "
                            "ops/cuda_curve.py (ROADMAP queue 2)"),
}

# Public names of a JAX module the port's counterpart lacks:
# (module, name) -> (the port's "module:name" that stands for it, or None;
# the reason).
NAME_EXCEPTIONS = {
    ("bindings/benchmarks.py", "benchmark_tpu_msm_best"): (
        "bindings/benchmarks.py:benchmark_gpu_msm_best",
        "the card is a GPU (ROADMAP queue 3: a rename)"),
    ("ops/ec_rows.py", "DualField"): (
        None, "the TPU's dual-stream pairing of two field cores (ROADMAP: "
        "not ported, by decision)"),
    ("ops/hist.py", "CHUNK"): (
        None, "the Pallas kernel's block of 2048 digits; the CUDA kernel's "
        "chunks come from hist.plan"),
    ("ops/hist.py", "digit_hist_pallas"): (
        "ops/hist.py:digit_hist",
        "one CUDA kernel for both Pallas histograms (PERF.md §6 row 8)"),
    ("ops/hist.py", "digit_hist_pallas2"): (
        "ops/hist.py:digit_hist",
        "one CUDA kernel for both Pallas histograms (PERF.md §6 row 7)"),
    ("ops/hist.py", "segment_starts_hist_pallas"): (
        "ops/hist.py:segment_starts_hist_cols",
        "segment_starts=\"hist_cols\" on the one kernel"),
    ("ops/hist.py", "segment_starts_hist_pallas2"): (
        "ops/hist.py:segment_starts_hist",
        "segment_starts=\"hist\" on the one kernel"),
    ("ops/u256.py", "U32"): (
        None, "jnp.uint32; the port holds u32 bit patterns in torch.int32 "
        "(torch's uint32 has no sort or gather on the card)"),
    ("ops/pippenger.py", "pack_u16_rows"): (
        "ops/cuda_curve.py:pack_u16_rows",
        "beside the kernels that read its words and pack_rows' plain "
        "version; ops/pippenger.py imports it, so callers find it there"),
    ("parallel/distributed.py", "global_mesh"): (
        "parallel/distributed.py:rank_device",
        "meshes become device lists: each rank names its card"),
    ("parallel/sharded.py", "default_mesh"): (
        "parallel/sharded.py:default_devices",
        "meshes become device lists (msm_sharded's devices=)"),
    ("parallel/sharded.py", "shard_arrays"): (
        "parallel/sharded.py:shard_tensors",
        "meshes become device lists (msm_sharded's devices=)"),
    ("utils/config.py", "resolve_backend"): (
        None, "chose Pallas or jnp by JAX backend; the port dispatches on "
        "the tensor's device (ROADMAP: the TPU schedule knob `backend`)"),
    ("utils/config.py", "enable_persistent_cache"): (
        None, "jax's persistent compile cache (ROADMAP: not ported, by "
        "decision); the CUDA kernels build once into build/"),
    ("utils/profiling.py", "MONT_MUL_U32_OPS"): (
        None, "the v5e VPU's op counts a product; the H100 model is "
        "CIOS_MULS_PER_MONT_MUL"),
    ("utils/profiling.py", "VPU_U32_OPS_PER_S"): (
        None, "the v5e VPU's rate; the H100 model is IMAD_PER_CLOCK_PER_SM "
        "at the card's SMs and clock"),
}

CONSTANT = re.compile(r"[A-Z][A-Z0-9_]*")


def public_names(path: Path) -> set:
    """Top-level public defs, classes and CONSTANTs of a module."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.update(n.id for t in targets for n in ast.walk(t)
                       if isinstance(n, ast.Name)
                       and CONSTANT.fullmatch(n.id))
    return {name for name in out if not name.startswith("_")}


def imported_modules(path: Path) -> set:
    """Every module an import statement of the file names, at any depth,
    and every constant `importlib.import_module` / `__import__` argument."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module)
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr",
                            getattr(node.func, "id", None)) in (
                                "import_module", "__import__"):
            out.add(node.args[0].value)
    return out


def _rel(paths, base):
    return sorted(str(p.relative_to(base)) for p in paths)


JAX_MODULES = _rel(JAX_PKG.rglob("*.py"), JAX_PKG)
ROOT_BENCHES = _rel((ROOT / "benches").glob("*.py"), ROOT / "benches")
PORT_FILES = _rel(PORT.rglob("*.py"), ROOT) + ["chip_smoke.py"]


def test_the_tables_name_real_modules():
    assert set(FILE_EXCEPTIONS) <= set(JAX_MODULES)
    assert {mod for mod, _ in NAME_EXCEPTIONS} <= set(JAX_MODULES)
    for _, reason in (*FILE_EXCEPTIONS.values(), *NAME_EXCEPTIONS.values()):
        assert reason.strip()


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_jax_module_has_a_counterpart(module):
    port = PORT / module
    if module in FILE_EXCEPTIONS:
        stands_for, _ = FILE_EXCEPTIONS[module]
        assert not port.exists(), f"{module} is ported now: drop its entry"
        for rel in stands_for or ():
            assert (PORT / rel).exists(), rel
        return
    assert port.exists(), f"tpu_msm/{module} has no tpu_msm_torch/{module}"
    missing = public_names(JAX_PKG / module) - public_names(port)
    excepted = {name for mod, name in NAME_EXCEPTIONS if mod == module}
    assert missing - excepted == set(), (
        f"tpu_msm/{module}: not in the port: {sorted(missing - excepted)}")
    for name in excepted:
        assert name in missing, f"{module}:{name} is ported now: drop it"
        assert name in public_names(JAX_PKG / module)
        stands_for, _ = NAME_EXCEPTIONS[(module, name)]
        if stands_for:
            rel, new = stands_for.split(":")
            assert new in public_names(PORT / rel), stands_for


@pytest.mark.parametrize("bench", ROOT_BENCHES)
def test_every_root_bench_has_a_counterpart(bench):
    port = PORT / "benches" / bench
    assert port.exists(), f"benches/{bench} has no tpu_msm_torch/benches/"
    missing = public_names(ROOT / "benches" / bench) - public_names(port)
    assert missing == set(), f"benches/{bench}: {sorted(missing)}"


@pytest.mark.parametrize("path", PORT_FILES)
def test_the_port_imports_no_jax(path):
    bad = {m for m in imported_modules(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "tpu_msm")}
    assert bad == set(), f"{path} imports {sorted(bad)}"
