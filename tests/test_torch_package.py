"""The torch port stands alone and refuses what it has not ported.

* no file of the port (nor `chip_smoke.py`) imports JAX or names the JAX
  package;
* importing every module of the port pulls in neither JAX, nor the JAX
  package, nor triton, and compiles nothing;
* every option of the JAX CLI runs: the sharded, multi-process and
  multi-device single-cell options that once raised `NotImplementedError`
  now run and match the JAX CLI, and no source cites a queue item;
* the default device is `cuda` and its absence is an error, never a quiet
  move to the CPU.
"""

import importlib
import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import oarfish_tpu_torch
from oarfish_tpu_torch import device as tdevice
from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.quant import bulk as tbulk
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "oarfish_tpu_torch"
JAX_PKG = "oarfish_" + "tpu"
FORBIDDEN = re.compile(r"import jax|from jax|" + JAX_PKG + r"(?!_torch)")


def port_sources():
    files = [p for p in PKG.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh", ".h", ".cpp")
             and "_build" not in p.parts]
    return files + [REPO / "chip_smoke.py"]


def module_names():
    return [m.name for m in pkgutil.walk_packages(
        oarfish_tpu_torch.__path__, "oarfish_tpu_torch.")]


def test_sources_exist():
    names = {p.relative_to(REPO).as_posix() for p in port_sources()}
    for need in ("oarfish_tpu_torch/csrc/sorted_gather.cu",
                 "oarfish_tpu_torch/csrc/tile_permute.cu",
                 "oarfish_tpu_torch/csrc/route_stage.cu",
                 "oarfish_tpu_torch/csrc/route_middle.cu",
                 "oarfish_tpu_torch/csrc/route_common.cuh",
                 "oarfish_tpu_torch/kernels/build.py",
                 "oarfish_tpu_torch/ops/sorted_gather.py",
                 "oarfish_tpu_torch/ops/tile_permute.py",
                 "oarfish_tpu_torch/ops/route_stage.py",
                 "oarfish_tpu_torch/ops/route_middle.py",
                 "oarfish_tpu_torch/ops/static_permute.py",
                 "oarfish_tpu_torch/ops/permute_plan.py",
                 "oarfish_tpu_torch/ops/balance.py",
                 "oarfish_tpu_torch/ops/em_v4.py",
                 "oarfish_tpu_torch/ops/plan_cache.py",
                 "oarfish_tpu_torch/ops/bootstrap.py",
                 "oarfish_tpu_torch/models/coverage_torch.py",
                 "oarfish_tpu_torch/ops/row_sums.py",
                 "oarfish_tpu_torch/ops/em_dense.py",
                 "oarfish_tpu_torch/quant/single_cell.py",
                 "oarfish_tpu_torch/io/fasta.py",
                 "oarfish_tpu_torch/host/mmi.py",
                 "oarfish_tpu_torch/host/mapper.py",
                 "oarfish_tpu_torch/genome/annotation.py",
                 "oarfish_tpu_torch/genome/g2t.py",
                 "oarfish_tpu_torch/genome/rescue.py",
                 "oarfish_tpu_torch/genome/project.py",
                 "oarfish_tpu_torch/genome/project_native.py",
                 "oarfish_tpu_torch/quant/raw_reads.py",
                 "oarfish_tpu_torch/quant/genome.py",
                 "oarfish_tpu_torch/quant/genome_reads.py",
                 "oarfish_tpu_torch/parallel/sharded_em.py",
                 "oarfish_tpu_torch/parallel/sharded_v4.py",
                 "oarfish_tpu_torch/parallel/multihost.py",
                 "oarfish_tpu_torch/device.py", "chip_smoke.py"):
        assert need in names
    from oarfish_tpu_torch.kernels import build

    for kernel in build.CUDA_KERNELS:
        assert f"oarfish_tpu_torch/csrc/{kernel}.cu" in names


@pytest.mark.parametrize(
    "path", [p.relative_to(REPO).as_posix() for p in port_sources()])
def test_source_does_not_name_jax(path):
    text = (REPO / path).read_text()
    hits = [ln for ln in text.splitlines() if FORBIDDEN.search(ln)]
    assert not hits, hits[:3]


def test_no_source_names_a_finished_queue_item():
    """Every item of queue A, the sharded and multi-process EMs (item 6)
    the last, and the replicate axis of the route kernels (queue B item 1)
    are ported: nothing in the port still points at them as work to do,
    and nothing raises `NotImplementedError` for them."""
    stale = re.compile(r"queue A item \d|queue B|NotImplementedError\(")
    for path in port_sources():
        hits = [ln for ln in path.read_text().splitlines()
                if stale.search(ln)]
        assert not hits, (path.name, hits[:3])


def test_kernel_wrappers_take_the_replicate_axis():
    """The wrappers of the route stage and the fused middle document and
    count the replicate-axis arm; their CUDA sources have it."""
    from oarfish_tpu_torch.utils import trace

    for kernel in ("route_stage", "route_middle"):
        assert isinstance(trace.counter(f"launch.{kernel}"), int)
        assert isinstance(trace.counter(f"launch.{kernel}.replicate"), int)
    for source in ("route_stage.cu", "route_middle.cu"):
        text = (PKG / "csrc" / source).read_text()
        assert "int B" in text and "Replicate axis" in text, source


def test_one_timing_mechanism():
    """The port times its phases and counts its launches through
    `utils/trace.py` alone: no function takes a `timings` dict to fill,
    and no module keeps a launch counter of its own."""
    timings = re.compile(r"\btimings\s*(:|=[^=])")
    counter = re.compile(r"^\s*(global\s.*)?\w*launch_count\w*\s*(=|\+=|$)",
                         re.M)
    for path in port_sources():
        text = path.read_text()
        assert not timings.search(text), (path.name, "timings")
        assert not counter.search(text), (path.name, "launch_count")


def test_import_needs_no_jax_triton_or_compiler(tmp_path):
    """A fresh interpreter imports every module of the port with JAX,
    the JAX package and triton made unimportable and with an empty PATH
    (no nvcc, no g++); nothing may be built by an import."""
    code = f"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'triton', {JAX_PKG!r}):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
for m in {module_names()!r}:
    if m.endswith('__main__'):
        continue
    importlib.import_module(m)
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'jaxlib', 'triton', {JAX_PKG!r})]
assert not bad, bad
from oarfish_tpu_torch.kernels import build
assert not build.build_seconds and not build._cuda_libs
print('ok')
"""
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={"PATH": str(tmp_path), "PYTHONPATH": str(REPO),
             "HOME": str(tmp_path)},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


def test_every_ported_module_names_its_counterpart():
    missing = []
    for name in module_names():
        mod = importlib.import_module(name) if not name.endswith(
            "__main__") else None
        if mod is None or Path(mod.__file__).name == "__init__.py":
            continue
        rel = Path(mod.__file__).relative_to(PKG).as_posix()
        if rel in ("device.py", "kernels/build.py", "ops/convert.py",
                   "utils/trace.py"):
            continue  # new in the port
        if "JAX package" not in (mod.__doc__ or ""):
            missing.append(rel)
    assert not missing, missing


BAM = ["--alignments", "x.bam", "-o", "out", "--device", "cpu"]


def quant_counts(path):
    rows = [ln.split("\t") for ln in Path(path).read_text().splitlines()[1:]]
    return np.array([float(r[2]) for r in rows])


def run_two_processes(argv, tmp_path):
    """The port's CLI as processes 0 and 1 of a gloo group on this host;
    process i writes to `tmp_path / f"p{i}"`."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "oarfish_tpu_torch", *argv, "-o",
         str(tmp_path / f"p{i}"), "--coordinator", f"localhost:{port}",
         "--process-id", str(i)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]


@pytest.mark.parametrize("argv,how", [
    # v3 across shards, without replicates, is the sharded segment-sum EM
    # in both packages, as is `auto` (segsum on the CPU)
    (["--em-impl", "v3", "--num-shards", "2"], "jax"),
    (["--num-shards", "2"], "jax"),
    (["--num-processes", "2"], "processes"),
    (["--single-cell", "--num-shards", "2"], "jax"),
])
def test_unported_options_raise(argv, how, tmp_path, monkeypatch):
    """The options that raised `NotImplementedError` until the sharded and
    multi-process EMs were ported now run on the CPU and match the JAX CLI
    given the same options (f64: rtol 1e-9 for the sharded EM, the
    single-cell files byte-equal); two processes match the JAX CLI's
    single-process run at rtol 1e-6, `tests/test_multiprocess.py`'s bar."""
    from oarfish_tpu.cli import main as jax_main
    from util_sim import simulate_bam

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OARFISH_JAX_CACHE", "0")
    single_cell = "--single-cell" in argv
    simulate_bam(tmp_path / "x.bam", num_reads=200, seed=8,
                 names=[f"t{i}" for i in range(6)],
                 lengths=[1000 + 200 * i for i in range(6)],
                 barcodes=[f"BC{i}" for i in range(4)] if single_cell
                 else None)
    base = ["--alignments", str(tmp_path / "x.bam"), "--em-dtype",
            "float64", "--quiet"]
    if how == "processes":
        run_two_processes(base + ["--device", "cpu", *argv], tmp_path)
        assert not list(tmp_path.glob("p1.*"))
        assert jax_main(base + ["-o", "j", "--em-impl", "segsum"]) == 0
        np.testing.assert_allclose(quant_counts("p0.quant"),
                                   quant_counts("j.quant"),
                                   rtol=1e-6, atol=1e-6)
        return
    assert torch_main(base + ["-o", "t", "--device", "cpu", *argv]) == 0
    assert jax_main(base + ["-o", "j", *argv]) == 0
    if single_cell:
        for ext in (".count.mtx", ".features.txt", ".barcodes.txt"):
            assert (Path(f"t{ext}").read_bytes()
                    == Path(f"j{ext}").read_bytes()), ext
        return
    np.testing.assert_allclose(quant_counts("t.quant"),
                               quant_counts("j.quant"), rtol=1e-9, atol=1e-9)
    assert (Path("t.ambig_info.tsv").read_bytes()
            == Path("j.ambig_info.tsv").read_bytes())


@pytest.mark.parametrize("argv", [
    ["--reads", "r.fq", "--annotated", "t.fa", "--seq-tech", "ont-cdna",
     "-o", "out", "--device", "cpu"],
    ["--genome-alignments", "g.bam", "--annotation", "a.gtf", "-o", "out",
     "--device", "cpu"],
    ["--only-index", "--index-out", "i.idx", "--annotated", "t.fa"],
], ids=["reads", "genome_alignments", "only_index"])
def test_raw_read_and_genome_modes_get_past_the_option_check(argv, tmp_path,
                                                             monkeypatch):
    """The raw-read and genome drivers (queue A item 5) are ported: the
    same command lines that raised `NotImplementedError` now run, and fail
    on the input that does not exist."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(OSError):
        torch_main(argv)
    assert not (tmp_path / "i.idx").exists()


def test_v4_is_ported_and_v3_is_not():
    """Since queue A item 7 both routed formulations are ported (and since
    item 6 no option check is left): each run fails on the missing
    input."""
    assert "v4" in tbulk.PORTED_IMPLS and "v3" in tbulk.PORTED_IMPLS
    for impl in ("v4", "v3"):
        with pytest.raises((OSError, ValueError)):
            torch_main(BAM + ["--em-impl", impl])


@pytest.mark.parametrize("item", [5, 6, 7, 9])
def test_roadmap_has_the_queue_items_named_in_errors(item):
    """Queue A keys its items by stable labels (`**A5:` ...), which errors
    once cited; each of these is recorded there as done, with its PR."""
    roadmap = (REPO / "ROADMAP.md").read_text()
    section = roadmap[roadmap.index("### A. Modules to port"):]
    section = section[:section.index("### B.")]
    entry = re.search(rf"\*\*A{item}:[^\n]*\n(?:   [^\n]*\n)*", section)
    assert entry, item
    assert re.search(r"Done in PR \d+", entry.group(0)), entry.group(0)


def test_errors_cite_exactly_the_open_queue_items():
    """No queue item is open, and no error or source cites one: the last,
    the sharded and multi-process EMs (item 6), is ported."""
    cited = {int(m) for p in port_sources()
             for m in re.findall(r"queue A item (\d+)", p.read_text())}
    assert sorted(cited) == []


def test_process_count_from_the_environment_raises(monkeypatch):
    """The JAX package's launcher variables are read where the flags are
    absent: a count above one without a process id raises `ValueError`
    before any input is opened or any group is joined (nothing detects a
    cluster). With all three variables the processes form a group
    (`tests/test_torch_multiprocess.py`)."""
    monkeypatch.setenv("OARFISH_NUM_PROCESSES", "2")
    monkeypatch.setenv("OARFISH_COORDINATOR", "localhost:1234")
    monkeypatch.delenv("OARFISH_PROCESS_ID", raising=False)
    for argv in (BAM, BAM + ["--single-cell"]):
        with pytest.raises(ValueError, match="OARFISH_PROCESS_ID") as e:
            torch_main(argv)
        assert "2 processes" in str(e.value)
    monkeypatch.setenv("OARFISH_NUM_PROCESSES", "1")
    with pytest.raises((OSError, ValueError)):  # past the check: no input
        torch_main(BAM)


def test_proc_placeholder_is_process_zero(tmp_path, monkeypatch):
    """`x.{proc}.bam` reads `x.0.bam` in one process, as the JAX CLI does:
    the same output files, byte for byte."""
    from oarfish_tpu.cli import main as jax_main
    from util_sim import simulate_bam

    monkeypatch.setenv("OARFISH_JAX_CACHE", "0")
    simulate_bam(tmp_path / "x.0.bam", num_reads=200, seed=8,
                 names=[f"t{i}" for i in range(6)],
                 lengths=[1000 + 200 * i for i in range(6)])
    argv = ["--alignments", str(tmp_path / "x.{proc}.bam"), "--em-dtype",
            "float64", "--em-impl", "segsum", "--quiet"]
    assert torch_main(argv + ["-o", str(tmp_path / "t"),
                              "--device", "cpu"]) == 0
    assert jax_main(argv + ["-o", str(tmp_path / "j")]) == 0
    for ext in (".quant", ".ambig_info.tsv"):
        assert ((tmp_path / f"t{ext}").read_bytes()
                == (tmp_path / f"j{ext}").read_bytes())
    meta = json.loads((tmp_path / "t.meta_info.json").read_text())
    assert meta["alignments"] == str(tmp_path / "x.0.bam")


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert tdevice.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device("cuda")
    # the CLI default is the same policy, checked before the BAM is read
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["--alignments", "does-not-exist.bam", "-o", "out"])


@pytest.mark.parametrize("factory", ["EmData", "FastEmData",
                                     "SortedGatherPlan", "EmV4Data",
                                     "BatchTilePermute", "GlobalRoute"])
def test_library_builders_default_to_cuda(factory):
    """A library caller who names no device gets the card or an error,
    never a quiet EM on the host."""
    import numpy as np

    from oarfish_tpu_torch.ops import (
        em,
        em_fast,
        em_v4,
        sorted_gather,
        static_permute,
    )

    txp_id = np.array([0, 1, 0], dtype=np.int32)
    w = np.ones(3)
    tile = static_permute.DeviceTilePlan.build(
        np.random.default_rng(0).permutation(128 * 128), 128)
    calls = {
        "EmData": lambda **kw: em.EmData.build(
            txp_id, w, np.array([0, 0, 1], dtype=np.int32), 2, 2, **kw),
        "FastEmData": lambda **kw: em_fast.FastEmData.build(
            txp_id, w, np.array([0, 2, 3]), 2, use_pallas_gather=True,
            **kw)[0],
        "SortedGatherPlan": lambda **kw: sorted_gather.SortedGatherPlan.build(
            np.arange(10), 100, **kw),
        "EmV4Data": lambda **kw: em_v4.EmV4Data.build(
            txp_id, w, np.array([0, 2, 3]), 2, **kw)[0],
        "BatchTilePermute": lambda **kw: static_permute.BatchTilePermute.build(
            [tile], **kw),
        "GlobalRoute": lambda **kw: static_permute.GlobalRoute(
            np.arange(10), np.arange(10)[::-1], 128 * 128, **kw).plan,
    }
    call = calls[factory]
    if torch.cuda.is_available():
        built = call()
        dev = built.base.device if factory == "SortedGatherPlan" else built.device
        assert dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    built = call(device="cpu")
    dev = built.base.device if factory == "SortedGatherPlan" else built.device
    assert dev.type == "cpu"


def test_device_and_dtype_policy():
    cpu = tdevice.resolve_device("cpu")
    assert cpu.type == "cpu"
    assert tdevice.resolve_em_dtype("auto", cpu) == torch.float64
    assert tdevice.resolve_em_dtype("auto", torch.device("cuda")) == torch.float32
    assert tdevice.resolve_em_dtype("float32", cpu) == torch.float32
    assert tdevice.resolve_em_dtype("float64", torch.device("cuda")) == torch.float64
    with pytest.raises(ValueError):
        tdevice.resolve_device("meta")
    with pytest.raises(ValueError):
        tdevice.resolve_em_dtype("bfloat16", cpu)
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("device,alns,max_iter,boots,want", [
    ("cpu", 6_000_000, 1000, 0, "segsum"),
    ("cpu", 10, 1000, 100, "segsum"),
    ("cuda", 6_000_000, 1000, 0, "v4"),
    ("cuda", 1_000_000, 1000, 0, "v4"),
    ("cuda", 999_999, 1000, 0, "pallas"),
    ("cuda", 6_000_000, 100, 0, "pallas"),   # < 150 expected iterations
    ("cuda", 6_000_000, 100, 1, "v4"),       # 100 * (1 + 1) replicates
    ("cuda", 6_000_000, 149, 0, "pallas"),
    ("cuda", 6_000_000, 150, 0, "v4"),
    ("cuda", 6_000_000, 10**6, 0, "v4"),     # capped at 1000 a run
    ("cuda", 5_000, 1000, 100, "pallas"),
])
def test_auto_impl_policy(device, alns, max_iter, boots, want):
    """The JAX package's rule, without its environment switch."""
    assert tbulk.choose_auto_impl(device, alns, max_iter, boots) == want


def test_cuda_kernel_build_raises_without_nvcc(monkeypatch):
    """No quiet way around a kernel that cannot be built."""
    from oarfish_tpu_torch.kernels import build

    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "_up_to_date", lambda lib, src: False)
    monkeypatch.setattr(build, "_cuda_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.cuda_library("sorted_gather")


def test_zlib_stand_in_decoder_reads_the_same_bam(tmp_path, monkeypatch):
    """Hosts without libdeflate build the shared BAM decoder against the
    zlib stand-in header; it must decode what the libdeflate build
    decodes."""
    import numpy as np

    from oarfish_tpu_torch.config import FilterOpts
    from oarfish_tpu_torch.host import native, packer
    from util_sim import simulate_bam

    bam = tmp_path / "s.bam"
    simulate_bam(bam, num_reads=300, seed=5,
                 names=[f"t{i}" for i in range(9)],
                 lengths=[900 + 150 * i for i in range(9)])

    def pack():
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_lib_tried", False)
        _, store, _, _ = packer.pack_bam_fast(bam, FilterOpts(), bin_width=100)
        return native.available(), store

    real = native.host_library
    with_default, store_a = pack()

    def no_libdeflate(name, source, flags=(), libs=()):
        if "-ldeflate" in libs:
            return None
        return real(name + "_zlib", source, flags, libs)

    monkeypatch.setattr(native, "host_library", no_libdeflate)
    with_zlib, store_b = pack()
    if not with_zlib:
        pytest.skip("no g++ or zlib on this host: pure-Python reader only")
    for f in ("txp_id", "start", "end", "as_prob", "boundaries"):
        np.testing.assert_array_equal(getattr(store_a, f), getattr(store_b, f))
    assert store_b.num_reads > 250
