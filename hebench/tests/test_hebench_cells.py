"""Every cell rehearsed on the CPU (the kernels' plain versions, tiny
configurations), its result line held to the benchmark's contract; every
piece found by name; and the check seen to fail under each fault a cell can
have."""

import json
import os
import re

import numpy as np
import pytest

from hebench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
       "per_layer"}


def _cells(spec):
    return [c["name"] for c in spec["workloads"]]


def test_benchmark_json_keeps_to_the_contract(spec):
    assert set(spec) == TOP
    assert spec["command"] == ["python3", "hebench/run.py"]
    assert spec["paths"] == ["hebench"] and 1 <= spec["run_seconds"] <= 51
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [c["name"] for c in spec["configs"]] + _cells(spec) + [
        m["name"] for m in metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        # every cell that reports the metric reports the one it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", _cells(spec)))
    for c in spec["workloads"]:
        assert c["chips"] == 1 and len(c["why"]) <= 200
        reports = [m for m in metrics if c["name"] in m.get("workloads", [c["name"]])]
        assert {"setup_s"} < {m["name"] for m in reports if m in spec["end_to_end"]}
        assert any(m in spec["per_layer"] for m in reports)


def test_every_piece_is_found_by_name(spec):
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == [] and cfg["source"] == c["source"]
        for kind in ("ops", "work"):
            assert run.load(kind, cfg["op"])
    for c in spec["workloads"]:
        run._cell(spec, c["name"])  # its configuration and traffic mix
    for m in spec["per_layer"]:
        assert callable(run.load("metrics", m["name"]).read)


def _meets_contract(line, spec, cell, trace):
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "compared"
    dev = line["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and dev["window_s"] > 0
        bd = line["breakdown"]
        assert all(len(bd[k]) <= 10 for k in ("device_ops", "idle_gaps"))
        wanted = {m["name"]: m for m in spec["per_layer"] if cell in m["workloads"]}
    else:
        wanted = {m["name"]: m for m in spec["end_to_end"]
                  if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == set(wanted)
    for name, v in line["metrics"].items():
        assert v["unit"] == wanted[name]["unit"] and v["value"] > 0


@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_rehearses(rehearse, spec, trace):
    for cell in _cells(spec):
        rc, line, err = rehearse(cell, trace=trace)
        assert rc == 0, err
        assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
        _meets_contract(line, spec, cell, trace)
        assert err.strip().splitlines()[-1].startswith("hebench compared: ")


def test_a_seed_gives_the_same_inputs(tiny_spec):
    import torch

    cell, cfg, traffic = run._cell(tiny_spec, "ks16384.stream")
    op = run.load("ops", cfg["op"])
    a, b, c = (op.Workload(cfg, 4, s, torch.device("cpu")) for s in (2**33 + 5,
                                                                      2**33 + 5, 7))
    assert (a.t == b.t).all() and (a.pristine == b.pristine).all()
    assert not (a.t == c.t).all()


def test_a_slot_after_many_uses_is_exact(tiny_spec):
    """r0 + k * delta mod q past k = 2^12, where a plain u64 product of a
    52-bit delta would wrap."""
    import torch

    cell, cfg, traffic = run._cell(tiny_spec, "ks16384.seal_call")
    op = run.load("ops", cfg["op"])
    w = op.Workload(cfg, 4, 2**33 + 11, torch.device("cpu"))
    uses = [1, 4095, 4096, 7_700 * 51, 2**40 + 7, 2**64 - 1]
    rows = [i % w.pool for i in range(len(uses))]
    once = np.random.default_rng(5).integers(0, 2**51, (len(rows), w.q_words.size),
                                             dtype=np.uint64) % w.q_words
    got = w.after(rows, once, uses)
    for i, (r, k) in enumerate(zip(rows, uses)):
        q = [int(v) for v in w.q_words]
        r0 = [int(v) for v in w.pristine[r]]
        want = [(a + k * (int(b) - a)) % m for a, b, m in zip(r0, once[i], q)]
        assert [int(v) for v in got[i]] == want, k


# -- faults planted in the port under the timed path ------------------------


def _api_fault(monkeypatch, method, fault):
    """Wrap TorchExecutor.<method> (a batch's submit) with a fault."""
    from hexl_fpga_tpu_torch.runtime import executors

    orig = getattr(executors.TorchExecutor, method)
    key = "result" if method == "submit_keyswitch" else "results"

    def submit(self, batch):
        if fault == "unchanged":
            return lambda: None
        if fault == "half_batch":
            return orig(self, batch[: len(batch) // 2])
        fin = orig(self, batch)

        def altered():
            fin()
            batch[-1].args[key].reshape(-1)[5] ^= np.uint64(1)

        return altered

    monkeypatch.setattr(executors.TorchExecutor, method, submit)


def _device_fault(monkeypatch, fault):
    from hexl_fpga_tpu_torch.ops import keyswitch_cuda

    orig = keyswitch_cuda.KeySwitchContext.dispatch_batch

    def dispatch(self, results, t_targets, keys, msf):
        if fault == "unchanged":
            return results.data.clone()
        out = orig(self, results, t_targets, keys, msf)
        if fault == "half_batch":
            out[out.shape[0] // 2:] = results.data[out.shape[0] // 2:]
        else:
            out.view(-1)[5] ^= 1
        return out

    monkeypatch.setattr(keyswitch_cuda.KeySwitchContext, "dispatch_batch", dispatch)


# (cell, fault): each fault a cell can have.  No cell crosses chips, so none
# has an exchange to leave out; a batch of one has no half to leave out.
FAULTS = [(c, f) for c in ("ks16384.stream", "dyadic16384x14.stream",
                           "ks16384.device", "ks16384.seal_call")
          for f in ("unchanged", "half_batch", "altered")
          if (c, f) != ("ks16384.seal_call", "half_batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(rehearse, monkeypatch,
                                                     cell, fault):
    """Each fault planted in the port: a step that leaves its result
    unchanged, half of the batch left out, an answer altered where it is
    produced."""
    if cell == "ks16384.device":
        _device_fault(monkeypatch, fault)
    else:
        method = "submit_dyadic_multiply" if "dyadic" in cell else "submit_keyswitch"
        _api_fault(monkeypatch, method, fault)
    rc, line, err = rehearse(cell, seconds=0.5, check_every=1)
    assert rc == 0, err
    assert line["correct"] is False
    assert line["compared"]["mismatched_words"]["value"] > 0
