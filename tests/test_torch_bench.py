"""The port's benchmark (`python -m oarfish_tpu_torch.bench`) against the
root `bench.py` and the JAX package, on the CPU at small shapes, and the
arithmetic `chip_smoke.py` turns a profiler window into per-m-step
figures with.

Shapes: `v4` and `pallas` at R = 4,000 reads, T = 500 transcripts; `v3`
at `tests/test_torch_em_v3.py`'s R = 60,000, T = 20,000, below which its
route geometry degenerates.

Tolerances: the CSR equals `bench.py`'s bit for bit. The fixed-iteration
counts in f64 (4 iterations at threshold -1.0) against the JAX package's
counterpart at rtol 1e-9, atol 1e-9: `v4` against its `make_runner`
(Pallas kernels in interpret mode; its weights are f32 values, which the
bench CSR's are); `pallas` against `run_em_fast` on the JAX package's
`fast` layout, the same m-step through an XLA gather (its Pallas gather
rounds an f64 table through f32); `v3` against the JAX package's f64
segment-sum `run_em`, since its v3 keeps weights and in-tile sums in f32,
and against its v3 `make_runner` at f32's rtol 1e-5, atol 1e-3.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops import em as jem
from oarfish_tpu.ops import em_fast as jfast
from oarfish_tpu.ops import em_v3 as jv3
from oarfish_tpu.ops import em_v4 as jv4
from oarfish_tpu_torch import bench as tb
from oarfish_tpu_torch.cli import main as cli_main
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "ms_per_iter", "vs_baseline"}
SMALL = (4000, 500)
V3 = (60_000, 20_000)
ITERS = 4


def shape(impl):
    return V3 if impl == "v3" else SMALL


def one_line(capsys) -> dict:
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_make_csr_equals_root_bench(monkeypatch):
    root = subprocess.run(
        [sys.executable, "-c", "import sys, bench; print(sorted("
         "m for m in ('torch', 'jax', 'scipy') if m in sys.modules))"],
        cwd=REPO, capture_output=True, text=True, check=True)
    assert root.stdout.strip() == "[]"  # the root bench imports numpy alone
    sys.path.insert(0, str(REPO))
    try:
        import bench
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(bench, "R", 3000)
    monkeypatch.setattr(bench, "T", 400)
    want = bench.make_csr()
    got = tb.make_csr(3000, 400)
    assert got[4] == want[4]
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the default shape is bench.py's
    assert (tb.R, tb.T, tb.MEAN_K, tb.ITERS) == (2_000_000, 200_000, 3, 50)


@pytest.mark.parametrize("impl,iters", [("v4", 2), ("pallas", 4),
                                        ("v3", 1)])
def test_main_prints_one_line(impl, iters, monkeypatch, capsys):
    monkeypatch.setenv("OARFISH_BENCH_IMPL", impl)
    reads, txps = shape(impl)
    before = (REPO / "BENCH_BASELINE.json").read_bytes()
    res = tb.main(["--device", "cpu", "--reads", str(reads), "--txps",
                   str(txps), "--iters", str(iters), "--pairs", "1"])
    line = one_line(capsys)
    assert set(line) == KEYS and line == res.line
    assert line["metric"] == "em_reads_per_sec" and line["value"] > 0
    assert line["ms_per_iter"] > 0
    assert f"f32 {impl} EM, cpu" in line["unit"]
    assert "baseline unpinned" in line["unit"]  # no pinned figure here
    # two loops of `iters` and two of 3 * `iters`, each with its final step
    assert res.m_steps == 2 * (iters + 1) + 2 * (3 * iters + 1)
    assert res.counts.sum() == pytest.approx(reads, rel=1e-5)
    assert (REPO / "BENCH_BASELINE.json").read_bytes() == before


def test_pinned_baseline_is_read_and_not_written(tmp_path, monkeypatch,
                                                 capsys):
    table = json.loads((REPO / "BENCH_BASELINE.json").read_text())
    table["R=4000,T=500,K=3"] = {"cpu_s_per_iter": 0.25}
    pinned = tmp_path / "BENCH_BASELINE.json"
    pinned.write_text(json.dumps(table))
    before = pinned.read_bytes()
    monkeypatch.setattr(tb, "BASELINE", pinned)
    monkeypatch.setenv("OARFISH_BENCH_IMPL", "pallas")
    tb.main(["--device", "cpu", "--reads", "4000", "--txps", "500",
             "--iters", "4", "--pairs", "2"])
    line = one_line(capsys)
    assert "baseline pinned NumPy CPU 0.25 s/iter" in line["unit"]
    assert line["vs_baseline"] == pytest.approx(
        250.0 / line["ms_per_iter"], rel=1e-2)
    assert pinned.read_bytes() == before
    assert tb.pinned_cpu_s_per_iter(2_000_000, 200_000) == pytest.approx(
        0.21168280400161166)
    assert tb.pinned_cpu_s_per_iter(200_000, 50_000) is not None


@pytest.mark.parametrize("impl", ["v4", "pallas", "v3"])
def test_fixed_iterations_equal_jax(impl):
    reads, txps = shape(impl)
    txp_id, w, boundaries, read_id, _ = tb.make_csr(reads, txps)
    form = tb.build(impl, txp_id, w, boundaries, txps, "cpu",
                    dtype=torch.float64)
    assert form.impl == impl
    got, niter = form.run(
        torch.full((txps,), reads / txps, dtype=torch.float64), ITERS)
    assert int(niter) == ITERS
    got = got.numpy()
    init = jnp.full(txps, reads / txps, dtype=jnp.float64)
    if impl == "v4":
        jd, _ = jv4.EmV4Data.build(txp_id, w, boundaries, txps)
        want, jn = jv4.make_runner(jd)(init, ITERS, -1.0)
    elif impl == "pallas":
        jd, _ = jfast.FastEmData.build(txp_id, w, boundaries, txps,
                                       dtype=jnp.float64)
        want, jn = jfast.run_em_fast(jd, init, ITERS, -1.0)
    else:
        jd = jem.EmData.build(txp_id, w, read_id, reads, txps,
                              dtype=jnp.float64)
        want, jn = jem.run_em(jd, init, ITERS, -1.0)
        v3d, _ = jv3.EmV3Data.build(txp_id, w, boundaries, txps)
        f32, _ = jv3.make_runner(v3d)(init, ITERS, -1.0)
        np.testing.assert_allclose(got, np.asarray(f32), rtol=1e-5,
                                   atol=1e-3)
    assert int(jn) == ITERS
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-9)


def test_e2e_quant_equals_cli(tmp_path, capsys):
    work = tmp_path / "work"
    argv = ["--e2e", "--device", "cpu", "--reads", "2000", "--txps", "300",
            "--work-dir", str(work)]
    tb.main(argv)
    line = one_line(capsys)
    assert line["metric"] == "e2e_bam_to_quant_s" and line["R"] == 2000
    assert {"value", "unit", "A", "reads_per_s", "cold", "warm",
            "warm_walls", "gen_s", "seed"} <= set(line)
    for run in (line["cold"], line["warm"]):
        assert run["impl"] == "segsum" and run["em_iters"] > 50
        assert run["counts_sum"] == pytest.approx(2000, rel=1e-9)
        assert {"decode_wait_s", "filter_s", "wall_s"} <= set(run["pack"])
        assert run["em_s"] >= 0 and run["route_build_s"] is None
    bam = work / "e2e_R2000_T300_s0.bam"
    assert bam.exists() and line["A"] > 2000
    rc = cli_main(["--alignments", str(bam), "-o", str(tmp_path / "cli"),
                   "--device", "cpu"])
    capsys.readouterr()
    assert rc == 0
    assert ((work / "out.quant").read_bytes()
            == (tmp_path / "cli.quant").read_bytes())
    # a second run finds the BAM and builds nothing
    tb.main(argv)
    assert one_line(capsys)["gen_s"] == 0.0
    shutil.rmtree(work)


@pytest.mark.parametrize("argv", [[], ["--e2e"]])
def test_main_raises_without_a_card(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main([*argv, "--reads", "1000", "--txps", "100",
                 "--work-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # it failed before any work


def test_profiler_window_per_m_step():
    """`chip_smoke.per_step`: a window's m-steps are the count of the
    kernel launched once each, not the calls made; a window that lost part
    of an m-step's records is refused."""
    from chip_smoke import per_step

    rows = [("route_middle_kernel<float, short, int>", 18, 2160.0),
            ("row_sums_kernel<float>", 18, 360.0),
            ("route_stage_shared_kernel<float>", 18, 1080.0),
            ("route_stage_gather_kernel<float>", 18, 990.0),
            ("tile_permute_kernel<float>", 36, 216.0),
            ("indexSelectLargeIndex", 18, 666.0)]
    got = per_step(rows, once="route_middle_kernel", calls=20)
    assert got["steps"] == 18 and got["launches"] == 6 + 1
    assert got["device_ms"] == pytest.approx(5472.0 / 18 / 1e3)
    assert got["calls_per_step"]["tile_permute_kernel<float>"] == 2
    assert got["device_us_per_step"]["row_sums_kernel<float>"] == 20.0
    # the same rows read per call of the 20 would be 10 % low
    assert got["device_ms"] > 5472.0 / 20 / 1e3
    lost = rows[:4] + [("tile_permute_kernel<float>", 35, 210.0)]
    assert per_step(lost, once="route_middle_kernel", calls=20) is None
    assert per_step(rows, once="sorted_gather_kernel", calls=20) is None
    assert per_step(rows, once="route_middle_kernel", calls=10) is None
    # without `once` the window holds `calls` steps
    assert per_step([("k", 40, 80.0)], calls=20)["launches"] == 2
    assert per_step([("k", 19, 80.0)], calls=20) is None
    assert per_step([], calls=20) is None  # the profiler dropped it all
