"""The harness with the timed path broken underneath: `correct` comes out
false for each fault a cell can have, and true without one. The look
for a card is skipped (the program runs on the CPU, `--device cpu`), the
rest of a run is driven at a size a test run holds. The bfloat16
control fails the limits too."""

import io
import json

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.calibrate import in_programs_place

from .conftest import tiny


def run_tiny(name, tmp_path, seed=2**31 + 11):
    err = io.StringIO()
    line = run.run_cell(tiny(name), seed, 1.0, False, device="cpu",
                        cache=tmp_path / "cache", stderr=err)
    return line, err.getvalue()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["bulk-boot100", "sc"])
def test_sound_run_is_correct(tmp_path, name):
    line, err = run_tiny(name, tmp_path)
    assert line["correct"], err
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert err.rstrip().splitlines()[-1].startswith("check ")


def unchanged_step(monkeypatch):
    import oarfish_tpu_torch.ops.em as em
    import oarfish_tpu_torch.quant.single_cell as sc

    # every m-step returns the state it was given
    for module in (em, sc):
        monkeypatch.setattr(module, "_m_step",
                            lambda data, prev, *a, **k: prev)


def half_batch(monkeypatch):
    import oarfish_tpu_torch.ops.bootstrap as boot

    real = boot.run_replicates

    def broken(run_one, mult, init, batch=boot.BOOT_BATCH):
        counts, iters = real(run_one, mult, init, batch)
        # the second half of each batch left out: its slots keep the
        # first half's answers
        for b0 in range(0, len(counts), batch):
            n = min(batch, len(counts) - b0)
            h = n // 2
            counts[b0 + h:b0 + 2 * h] = counts[b0:b0 + h]
        return counts, iters

    monkeypatch.setattr(boot, "run_replicates", broken)


def altered_quant(monkeypatch):
    import oarfish_tpu_torch.quant.bulk as bulk

    real = bulk.write_output

    def broken(output, info, names, lens, counts, *rest):
        counts = np.array(counts, dtype=np.float64)
        counts[np.argmax(counts)] *= 2
        return real(output, info, names, lens, counts, *rest)

    monkeypatch.setattr(bulk, "write_output", broken)


def altered_cell(monkeypatch):
    import oarfish_tpu_torch.quant.single_cell as sc

    real = sc.write_single_cell_output

    def broken(output, info, names, barcodes, rows, cols, vals, n):
        vals = np.array(vals)
        vals[rows == rows[0]] *= 2
        return real(output, info, names, barcodes, rows, cols, vals, n)

    monkeypatch.setattr(sc, "write_single_cell_output", broken)


@pytest.mark.parametrize("name,fault", [
    ("bulk-boot100", unchanged_step),
    ("bulk-boot100", half_batch),
    ("bulk-boot100", altered_quant),
    ("sc", unchanged_step),
    ("sc", altered_cell),
], ids=["bulk-unchanged-step", "bulk-half-batch", "bulk-altered-answer",
        "sc-unchanged-step", "sc-altered-answer"])
def test_fault_is_not_correct(tmp_path, monkeypatch, name, fault):
    fault(monkeypatch)
    line, err = run_tiny(name, tmp_path)
    assert not line["correct"]
    json.loads(json.dumps(line, allow_nan=False))
    over = [k for k, v in line["checks"].items()
            if v["value"] is None or v["value"] > v["limit"]]
    assert over, err


def test_a_job_that_raises_fails_the_run(tmp_path, monkeypatch):
    import oarfish_tpu_torch.quant.bulk as bulk

    real = bulk.perform_inference_and_write_output
    calls = []

    def broken(*a, **k):
        # the warm-up job runs; every measured job raises
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("a fault after the pack")
        return real(*a, **k)

    monkeypatch.setattr(bulk, "perform_inference_and_write_output", broken)
    line, err = run_tiny("bulk-boot100", tmp_path)
    assert not line["correct"] and line["failed"] == line["attempted"] >= 1
    assert all(v["value"] is None for v in line["checks"].values())
    json.loads(json.dumps(line, allow_nan=False))


@pytest.mark.parametrize("name", ["bulk-boot100", "sc"])
def test_bf16_control_is_not_correct(tmp_path, name):
    """The control: the reference in bfloat16 put in the program's place
    where the jobs write their answers, judged by the run's own
    comparison of the files written."""
    cell = tiny(name)
    cell.traffic["inputs"] = 1
    seed = 2**31 + 11
    inputs = run.start_inputs(cell, tmp_path / "cache")
    inputs.wait_all()
    with in_programs_place(cell, inputs.jobs[0], seed, "cpu",
                           torch.bfloat16):
        line = run.run_cell(cell, seed, 1.0, False, device="cpu",
                            cache=tmp_path / "cache", stderr=io.StringIO())
    assert line["failed"] == 0 and not line["correct"]
    over = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert over, line["checks"]


def test_a_window_holds_min_jobs(tmp_path):
    cell = tiny("bulk-boot100")
    cell.traffic["min_jobs"] = 3
    err = io.StringIO()
    line = run.run_cell(cell, 9, 0.001, False, device="cpu",
                        cache=tmp_path / "cache", stderr=err)
    assert line["attempted"] == 3 and line["correct"], err.getvalue()


@pytest.mark.parametrize("name", ["bulk-boot100", "sc"])
def test_calibrate_reads_the_program_and_the_control(tmp_path, monkeypatch,
                                                     capsys, name):
    from perfbench import calibrate, spec

    cell = tiny(name)
    monkeypatch.setattr(spec, "load_cell", lambda _: cell)
    assert calibrate.main(["--workload", name, "--seeds", "4-5",
                           "--control", "1", "--device", "cpu",
                           "--cache", str(tmp_path)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [4, 5]
    assert all(not x["errors"] and x["program"] for x in lines)
    assert lines[0]["control_correct"] is False
    assert "control_bf16" not in lines[1]
    # each seed's sample is made from it, and deleted once judged
    assert not [p for p in tmp_path.glob("*/in0.bam")
                if "warmup" not in p.parent.name]
