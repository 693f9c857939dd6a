"""The port's benchmarks (``repro_torch.bench``) against ``repro``'s
(``benchmarks/``), on the CPU.

The smoke bench record is built in both packages with ``impl="ref"`` and
must agree exactly in every field that is not a time: layer names,
dataflows, epilogue tags, MACs, bytes, the analytic side, the fused-delta
block bytes and the sparse-delta bytes.  ``tile_util`` is left out: it is
the padding waste of each package's own kernel tiles (the CUDA kernels'
here, the Pallas kernels' there).  No test compares a time with a
committed number.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bench import check_regression as cr
from repro_torch.bench import kernel_bench, paper_figures, run, timer
from repro_torch.bench import telemetry_report as tr

ROOT = Path(__file__).resolve().parents[1]
SMOKE_NETS = ["smoke", "smoke_fused", "smoke_sparse"]
LAYER_KEYS = ("layer", "dataflow", "epilogue", "macs", "dense_twin_macs",
              "bytes_mb", "fused_saved_mb", "analytic_ms", "analytic_puf",
              "pruned", "keep_fraction", "tuned", "tile_config",
              "tuning_source")
BLOCK_KEYS = ("block", "layers", "fused_bytes_mb", "unfused_bytes_mb",
              "saved_mb", "analytic_saved_mb")
SPARSE_KEYS = ("layer", "pruned", "keep_fraction", "dense_bytes_mb",
               "sparse_bytes_mb", "saved_mb")


@pytest.fixture(scope="module")
def port_record():
    return tr.collect_bench(SMOKE_NETS, reps=1, impl="ref", smoke=True,
                            device="cpu")


@pytest.fixture(scope="module")
def repro_record():
    from benchmarks.telemetry_report import collect_bench
    return collect_bench(SMOKE_NETS, reps=1, impl="ref", smoke=True)


@pytest.mark.parametrize("net", SMOKE_NETS)
def test_smoke_record_layers_equal_repros(port_record, repro_record, net):
    got = port_record["networks"][net]["layers"]
    want = repro_record["networks"][net]["layers"]
    assert [l["layer"] for l in got] == [l["layer"] for l in want]
    for g, w in zip(got, want):
        assert {k: g[k] for k in LAYER_KEYS} == {k: w[k] for k in LAYER_KEYS}
    for key in ("total_analytic_ms", "total_fused_saved_mb",
                "mac_keep_fraction"):
        assert port_record["networks"][net][key] == \
            repro_record["networks"][net][key], key


def test_smoke_fused_and_sparse_deltas_equal_repros(port_record,
                                                    repro_record):
    for got, want in zip(port_record["fused_delta"]["smoke"]["blocks"],
                         repro_record["fused_delta"]["smoke"]["blocks"],
                         strict=True):
        assert {k: got[k] for k in BLOCK_KEYS} == \
            {k: want[k] for k in BLOCK_KEYS}
    got_sd = port_record["sparse_delta"]["smoke"]
    want_sd = repro_record["sparse_delta"]["smoke"]
    assert got_sd["pruned_layers"] == want_sd["pruned_layers"]
    assert got_sd["total_saved_mb"] == want_sd["total_saved_mb"]
    for got, want in zip(got_sd["layers"], want_sd["layers"], strict=True):
        assert {k: got[k] for k in SPARSE_KEYS} == \
            {k: want[k] for k in SPARSE_KEYS}


def test_smoke_record_names_its_clock_and_device(port_record):
    assert port_record["timer"] == "host"
    assert port_record["backend"] == "cpu"
    assert port_record["device"] == {"name": "cpu",
                                     "power_limit": "not measured"}
    assert port_record["version"] == 4
    for net in port_record["networks"].values():
        assert all(l["host_ms"] > 0 for l in net["layers"])
        assert net["total_host_ms"] > 0


def test_smoke_record_holds_both_byte_invariants(port_record):
    blocks = port_record["fused_delta"]["smoke"]["blocks"]
    assert blocks and all(b["fused_bytes_mb"] < b["unfused_bytes_mb"]
                          for b in blocks)
    pruned = [l for l in port_record["sparse_delta"]["smoke"]["layers"]
              if l["pruned"]]
    assert pruned and all(l["sparse_bytes_mb"] < l["dense_bytes_mb"]
                          for l in pruned)
    assert cr.compare(port_record, port_record) == []
    assert not [p for p in cr.check_sparse(port_record) if "bytes" in p]


def test_gate_trips_on_a_slowdown_and_a_sparse_violation(port_record):
    assert cr.compare(port_record, port_record) == []
    slow = cr.inject_slowdown(port_record, 2.0)
    problems = cr.compare(port_record, slow)
    assert any("total" in p for p in problems)
    assert any("smoke_7x7" in p for p in problems)
    ratio, _ = cr.worst_ratio(port_record, slow)
    assert ratio == pytest.approx(2.0)
    bad = cr.inject_sparse_violation(port_record)
    assert any("not strictly below" in p for p in cr.check_sparse(bad))
    assert not any("not strictly below" in p
                   for p in cr.check_sparse(port_record))


def test_fused_invariant_is_exact(port_record):
    bad = json.loads(json.dumps(port_record))
    blk = bad["fused_delta"]["smoke"]["blocks"][0]
    blk["fused_bytes_mb"] = blk["unfused_bytes_mb"]
    assert any("fused path bytes" in p for p in cr.compare(port_record, bad))


def test_check_bytes_holds_both_exact_invariants(port_record):
    """``check_bytes`` is the one place of both byte invariants: empty on
    the smoke record and on the committed baseline, and naming each
    violation once when both are planted."""
    assert cr.check_bytes(port_record) == []
    assert cr.check_bytes(cr.load(cr.DEFAULT_BASELINE)) == []
    bad = cr.inject_sparse_violation(port_record)
    blk = bad["fused_delta"]["smoke"]["blocks"][0]
    blk["fused_bytes_mb"] = blk["unfused_bytes_mb"] + 1.0
    problems = cr.check_bytes(bad)
    n_pruned = sum(l["pruned"]
                   for l in bad["sparse_delta"]["smoke"]["layers"])
    assert len(problems) == 1 + n_pruned
    assert sum("fused path bytes" in p for p in problems) == 1
    assert cr.fused_bytes_problems(bad) == problems[:1]
    assert cr.sparse_bytes_problems(bad) == problems[1:]


def test_a_full_network_total_is_banded_at_its_spread():
    """A full network's total slower by 5 % (several times the 1.3 % its
    H100 records spread) fails the gate; within the spread it passes."""
    base = cr.load(cr.DEFAULT_BASELINE)
    for factor, fails in ((1.05, True), (1.013, False)):
        problems = cr.compare(base, cr.inject_slowdown(base, factor))
        totals = [p for p in problems if ": total " in p]
        assert bool(totals) == fails, (factor, totals)
        if fails:
            assert any(p.startswith("resnet50: total") for p in totals)


def test_compare_refuses_a_host_record_against_an_event_record(port_record):
    event = dict(port_record, timer=tr.CUDA_TIMER)
    with pytest.raises(ValueError, match="clocks"):
        cr.compare(event, port_record)
    with pytest.raises(ValueError, match="clocks"):
        cr.compare(port_record, event)


def test_check_tuning_bands_tuned_against_default():
    rec = {"tuning": {"resnet50": {"layers": [
        {"layer": "a", "tuned": True, "tile_config": "t", "default_ms": 0.1,
         "tuned_ms": 0.11},
        {"layer": "b", "tuned": False}]}}}
    assert cr.check_tuning(rec) == []
    rec["tuning"]["resnet50"]["layers"][0]["tuned_ms"] = 0.2
    assert len(cr.check_tuning(rec)) == 1


def _restamped_tables(tmp_path, alter: str | None):
    """The committed tables copied to tmp_path, stamped for this machine
    (a table of another device is skipped, never read), one of them with
    an altered kernel hash."""
    from repro_torch.core import autotune
    src = Path(autotune._TUNED_DIR)
    names = sorted(p.name for p in src.glob("*.json"))
    assert names
    for name in names:
        doc = json.loads((src / name).read_text())
        doc.update(backend=autotune.backend(), device=autotune.device_name())
        if name == alter:
            doc["kernel_hash"] = "0" * len(doc["kernel_hash"])
        (tmp_path / name).write_text(json.dumps(doc))
    return names


def test_stale_table_check(tmp_path, monkeypatch):
    from repro_torch.core import autotune
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "user"))
    assert cr.check_stale_tables() == []
    monkeypatch.setenv("REPRO_TORCH_TUNED_TABLES_DIR", str(tmp_path))
    names = _restamped_tables(tmp_path, alter=None)
    assert cr.check_stale_tables() == []
    _restamped_tables(tmp_path, alter=names[0])
    problems = cr.check_stale_tables()
    assert len(problems) == 1 and names[0] in problems[0]
    autotune.reset()


def test_committed_baseline_loads_and_holds_both_invariants():
    rec = cr.load(cr.DEFAULT_BASELINE)
    assert Path(cr.DEFAULT_BASELINE).name == "BENCH_21.json"
    assert rec["timer"] == tr.CUDA_TIMER and rec["backend"] == "cuda"
    assert "H100" in rec["device"]["name"] and rec["device"]["power_limit"]
    nets = set(rec["networks"])
    assert {"resnet50", "resnet50_fused", "resnet50_sparse", "vgg16",
            "vgg16_fused", "smoke", "smoke_fused", "smoke_sparse"} <= nets
    assert rec["tuned"] and rec["tuning"]
    blocks = [b for fd in rec["fused_delta"].values() for b in fd["blocks"]]
    assert len(blocks) >= 16 + 13
    assert all(b["fused_bytes_mb"] < b["unfused_bytes_mb"] for b in blocks)
    pruned = [l for sd in rec["sparse_delta"].values() for l in sd["layers"]
              if l["pruned"]]
    assert pruned and all(l["sparse_bytes_mb"] < l["dense_bytes_mb"]
                          for l in pruned)
    assert cr.compare(rec, rec) == []


def test_committed_baseline_bytes_equal_a_cpu_record(port_record):
    """Bytes and the analytic side are the shapes': the card's smoke
    record equals the CPU's in them."""
    rec = cr.load(cr.DEFAULT_BASELINE)
    for net in SMOKE_NETS:
        for g, w in zip(rec["networks"][net]["layers"],
                        port_record["networks"][net]["layers"], strict=True):
            assert {k: g[k] for k in LAYER_KEYS if k not in
                    ("tuned", "tile_config", "tuning_source")} == \
                {k: w[k] for k in LAYER_KEYS if k not in
                 ("tuned", "tile_config", "tuning_source")}


def test_run_cli_writes_a_cpu_record(tmp_path):
    out = tmp_path / "bench.json"
    run.main(["--smoke", "--impl", "ref", "--device", "cpu", "--sparse",
              "--bench-json", str(out)])
    rec = cr.load(str(out))
    assert set(rec["networks"]) == set(SMOKE_NETS)
    assert rec["timer"] == "host" and rec["impl"] == "ref"
    assert rec["fused_delta"]["smoke"]["blocks"]
    assert rec["sparse_delta"]["smoke"]["pruned_layers"] == 4


def _steady(record: dict) -> dict:
    """The record with every time set to 1 ms: the CLI's verdicts on it
    do not depend on the host clock's noise (the pruned-vs-dense time band
    compares two host times within one CPU record)."""
    rec = json.loads(json.dumps(record))
    for net in rec["networks"].values():
        net["total_measured_ms"] = float(len(net["layers"]))
        for layer in net["layers"]:
            layer["measured_ms"] = 1.0
    for sd in rec["sparse_delta"].values():
        for layer in sd["layers"]:
            layer["dense_ms"] = layer["sparse_ms"] = 1.0
    return rec


def test_check_regression_cli_against_a_candidate(tmp_path, port_record,
                                                  monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "user"))
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(_steady(port_record)))
    args = ["--baseline", str(path), "--candidate", str(path)]
    cr.main(args)
    assert "PASS" in capsys.readouterr().out
    for extra in (["--inject-slowdown", "2"], ["--inject-sparse-violation"]):
        with pytest.raises(SystemExit) as e:
            cr.main(args + extra)
        assert e.value.code == 1
    event = tmp_path / "event.json"
    event.write_text(json.dumps(dict(port_record, timer=tr.CUDA_TIMER)))
    with pytest.raises(SystemExit, match="clocks"):
        cr.main(["--baseline", str(event), "--candidate", str(path)])


def test_tuning_delta_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch.tune import collect_tuning_delta
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collect_tuning_delta("smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.collect_bench(["smoke"], reps=1, tuned=True)


@pytest.mark.parametrize("fn", paper_figures.ALL, ids=lambda f: f.__name__)
def test_paper_figures_equal_repros(fn):
    from benchmarks import paper_figures as repro_figures
    assert fn() == getattr(repro_figures, fn.__name__)()


def test_paper_figures_headline_numbers():
    rows = {r[0]: r[1] for r in paper_figures.table2_comparison()[2]}
    assert rows["ResNet-50 latency (ms)"] == "92.8"
    assert rows["sparse ResNet-50 latency (ms)"] == "42.5"
    assert rows["VGG-16 latency (ms)"] == "393.1"
    assert run.fidelity_gate()


@pytest.fixture(scope="module")
def dryrun_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", "smollm-135m", "--shape", "train_4k",
                    "--smoke", "--out", str(out)], check=True, env=env,
                   capture_output=True, timeout=600, cwd=ROOT)
    return out


def test_roofline_table_builds_from_a_port_record(dryrun_dir):
    from repro_torch.bench import roofline
    title, headers, rows = roofline.roofline_table("single", str(dryrun_dir))
    assert len(rows) == 1 and rows[0][:2] == ["smollm-135m", "train_4k"]
    cells = dict(zip(headers, rows[0]))
    assert cells["compile s"] == "n/a"          # no compile in an eager step
    assert cells["bound"] in ("compute", "memory", "collective")
    assert cells["trace s"] != "n/a" and cells["peakGiB"] != "n/a"
    assert roofline.roofline_table("multi", str(dryrun_dir))[2] == []


def test_experiments_md_builds_from_port_records(dryrun_dir, tmp_path):
    from repro_torch.bench import make_experiments_md as mem
    out = tmp_path / "EXPERIMENTS.md"
    mem.main(["--base", str(dryrun_dir), "--opt", str(dryrun_dir),
              "--out", str(out)])
    text = out.read_text()
    assert "| smollm-135m | train_4k |" in text
    assert "1.00x" in text                  # the record against itself
    assert "92.8" in text and "n/a" in text


def test_roofline_field_says_na_for_missing_keys():
    from repro_torch.bench.roofline import field, roofline_fraction
    rec = {"roofline": {"compute_s": 1.0, "memory_s": 2.0,
                        "collective_s": 0.5}, "hlo": {"ops_per_dev": 3}}
    assert field(rec, "compile_s") == "n/a"
    assert field(rec, "roofline", "memory_s", fmt="{:.1f}", scale=1e3) \
        == "2000.0"
    assert roofline_fraction(rec).strip() == "50.0%"
    assert roofline_fraction({}) == "n/a"


def test_dryrun_writes_apart_from_repros_records():
    from repro_torch.launch import dryrun
    from repro_torch.bench import roofline
    assert dryrun.DEFAULT_OUT == os.path.join("experiments", "dryrun_torch")
    assert roofline.DRYRUN_DIR == str(ROOT / "experiments" / "dryrun_torch")


def test_kernel_bench_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m",
                          "repro_torch.bench.kernel_bench"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_kernel_bench_conv1d_turns_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m",
                          "repro_torch.bench.kernel_bench", "--conv1d-against",
                          str(ROOT / "src/repro_torch/kernels/csrc/conv1d.cu")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_one_cold_l2_timer():
    """The tuner, the bench record, the kernel bench and chip_smoke.py time
    through the same function."""
    import chip_smoke
    from repro_torch.launch import tune
    assert tune.cold_time_ms is timer.cold_time_ms
    assert chip_smoke.cold_time_ms is timer.cold_time_ms
    assert kernel_bench.cold_time_ms is timer.cold_time_ms
    assert tr.cold_times_ms is timer.cold_times_ms


def test_kernel_bench_costs_and_cases():
    """The shared cases: the bound counts each input once and each output
    once, and attention only the pairs its mask lets in."""
    fa = kernel_bench.flash_case(1, 4, 2, 1, 16)
    flops, nbytes = kernel_bench.lm_cost(fa, torch.bfloat16, ())
    assert flops == 4 * 2 * 16 * (1 + 2 + 3 + 4)
    assert nbytes == 2 * 4 * (2 + 1) * 16 * 2
    fw = kernel_bench.flash_case(1, 4, 2, 1, 16, window=2)
    assert kernel_bench.lm_cost(fw, torch.bfloat16, ())[0] == \
        4 * 2 * 16 * (1 + 2 + 2 + 2)
    da = kernel_bench.decode_case(2, 10, 2, 1, 16, (3, 9), ring=5)
    assert kernel_bench.kernel_pos(da, da["pos"]) == (3, 4)
    assert kernel_bench.visible_rows(da, da["pos"]) == [4, 5]
    names = [n for n, _, _ in kernel_bench.bench_cases()]
    assert "smollm-360m smoke dh 20" in names
    assert {c["dh"] for c in kernel_bench.dh20_cases()} == {20}
    assert kernel_bench.dh20_cases()[0] in kernel_bench.lm_kernel_cases()
    # the paths no config has: conv1d at FL 1, 5, 7, 9; attention above dh
    # 256 with offsets (k and v hold the keys a query offset sees) and the
    # log-sum-exp
    cases = kernel_bench.lm_kernel_cases()
    assert {c["fl"] for c in cases if c["kernel"] == "conv1d_causal"} >= \
        {1, 5, 7, 9}
    assert {c["dh"] for c in cases if c["kernel"] != "conv1d_causal"} >= \
        {272, 384, 512, 1024}
    gen = torch.Generator().manual_seed(0)
    (q, k, _), kw = kernel_bench.lm_operands(
        kernel_bench.flash_case(1, 5, 2, 1, 272, q_offset=3), torch.float32,
        gen)
    assert (q.shape[1], k.shape[1], kw["q_offset"]) == (5, 8, 3)
    _, kw = kernel_bench.lm_operands(
        kernel_bench.decode_case(1, 6, 2, 1, 272, (9,), k_offset=4, lse=True),
        torch.float32, gen)
    assert (kw["k_offset"], kw["return_lse"]) == (4, True)
    assert "q_offset" not in kernel_bench.lm_operands(fa, torch.float32,
                                                      gen)[1]
