"""The port's campaign tools against the JAX package's ``tools/``.

* ``summarize_campaign``: the same JSON as ``tools/summarize_campaign.py``
  (loaded by path; it imports no JAX) on the JAX package's 300 ms
  campaign and on a seeded synthetic campaign whose log has a resume seam;
* ``accuracy_flagship compare``: the same table and JSON as the JAX
  tool's ``_compare`` on two seeded legs; a driver campaign directory as
  the first leg gives the rows of the trace keys both sides have and the
  final fields of its checkpoint;
* ``accuracy_flagship run``: a float64 leg on the CPU at ``mesh_n`` 10,
  15 steps across the source onset, against the JAX tool's ``_run_leg``
  (float64 on the CPU): traces and final fields to 1e-9 relative,
  iteration counts equal (the JAX example takes its per-ion KNP branch
  on the CPU, so the port's leg runs ``knp_batched: false``);
* a leg stopped after a checkpoint and resumed equals an unbroken leg
  bit for bit, refreshes of the EMI hierarchy included;
* the committed ``results_torch/flagship_300ms`` record is what the
  port's tools compute from its committed traces, log and twin.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from knpemi_tpu_torch.tools import accuracy_flagship as acc
from knpemi_tpu_torch.tools import campaign_record as rec_mod
from knpemi_tpu_torch.tools import summarize_campaign as summ

ROOT = Path(__file__).resolve().parents[1]
JAX_CAMPAIGN = ROOT / "results" / "flagship_300ms"
RECORD = ROOT / "results_torch" / "flagship_300ms"
BASELINE_YML = ROOT / "examples" / "astrocyte" / "config_files" / "baseline.yml"


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_summary(monkeypatch, capsys, *argv):
    monkeypatch.setattr(sys, "argv", ["summarize_campaign.py", *map(str, argv)])
    _jax_tool("summarize_campaign").main()
    return json.loads(capsys.readouterr().out)


def test_summary_of_the_jax_campaign_equals_jax_tools(monkeypatch, capsys):
    args = (JAX_CAMPAIGN / "campaign_300ms", "--log", JAX_CAMPAIGN / "campaign_all.log")
    ref = _jax_summary(monkeypatch, capsys, *args)
    out = summ.main(list(map(str, args)))
    capsys.readouterr()
    assert out == ref
    assert out["n_saves"] == 600 and out["relaxation_phase"]["chunks"] > 0


def _synthetic_campaign(tmp_path, seed=7):
    """A 40 ms campaign of 80 saves, and a log of two legs joined at a
    resume from step 250 (the first leg ran to step 300: 50 steps redone)."""
    rng = np.random.default_rng(seed)
    d = tmp_path / "campaign"
    d.mkdir()
    n = 80
    t = 0.5 * np.arange(1, n + 1)
    ke = 3.09 + np.concatenate([np.linspace(0, 6, 40), np.linspace(6, 2, 40)]) \
        + 0.01 * rng.standard_normal(n)
    vn = -75 + 4 * rng.random(n)
    vn[30] = -10.0  # one crossing of -20 mV
    np.savez(d / "traces.npz", t=t, phi_M_neuron=vn, phi_M_glial=-85 + 10 * rng.random(n),
             K_e_max=ke, K_e_min=ke - 0.1)
    lines = ["set-up 40.0s"]
    for a in range(1, 301, 5):
        lines.append(f"  steps {a}..{a + 4}: {rng.uniform(200, 400):.2f} ms/step, "
                     f"emi_it={rng.integers(6, 12)} knp_it={rng.integers(2, 10)}")
    lines.append("resumed from out/campaign/ckpt.npz: step 250, t = 25.000 ms, 50 saves")
    for a in range(1, 151, 5):
        lines.append(f"  steps {a}..{a + 4}: {rng.uniform(200, 400):.2f} ms/step, "
                     f"emi_it={rng.integers(6, 8)} knp_it={rng.integers(2, 4)}")
    (tmp_path / "campaign.log").write_text("\n".join(lines) + "\n")
    return d


def test_summary_across_a_resume_seam_equals_jax_tools(monkeypatch, capsys, tmp_path):
    d = _synthetic_campaign(tmp_path)
    ref = _jax_summary(monkeypatch, capsys, d, "--stim-end", "20")
    out = summ.main([str(d), "--stim-end", "20"])
    capsys.readouterr()
    assert out == ref
    rows = summ.parse_log(tmp_path / "campaign.log")
    assert len(rows) == 90 and rows[59, 0] == 300 and rows[60, 0] == 255 and rows[-1, 0] == 400
    assert out["neuron_ap_crossings"] == 1
    assert out["stimulated_phase"]["chunks"] + out["relaxation_phase"]["chunks"] == 90


SIZES = dict(phi_M_1=12, phi_M_2=10, phi_0=40, c_K_0=40, c_Na_0=40, c_K_1=30)


def _legs(tmp_path, seed=11, n=60):
    """Two seeded legs with every key of a ``run`` output: A float32, B float64."""
    rng = np.random.default_rng(seed)
    t = 0.5 * np.arange(1, n + 1)
    b = dict(t=t, phi_M_neuron=-70 + rng.standard_normal(n),
             phi_M_glial=-80 + rng.standard_normal(n), K_e_max=3 + rng.random(n),
             phi_e_norm=rng.random(n), it_emi=rng.integers(5, 12, 10 * n),
             it_knp=rng.integers(2, 10, 10 * n), wall=np.float64(12.5))
    for k in acc.FINAL_KEYS:
        b[f"final_{k}"] = rng.standard_normal(SIZES[k])
    a = {k: (v * (1 + 1e-3 * rng.standard_normal(v.shape))).astype(np.float32)
         if v.dtype.kind == "f" and v.ndim else v for k, v in b.items()}
    a["t"] = t.astype(np.float32)
    paths = tmp_path / "a.npz", tmp_path / "b.npz"
    np.savez(paths[0], **a)
    np.savez(paths[1], **b)
    return paths, a, b


def test_compare_equals_jax_tools(tmp_path, capsys):
    (pa, pb), _, _ = _legs(tmp_path)
    ref = _jax_tool("accuracy_flagship")._compare(pa, pb)
    ref_text = capsys.readouterr().out
    out = acc.main(["compare", str(pa), str(pb)])
    assert capsys.readouterr().out == ref_text
    assert out == ref and len(ref_text.splitlines()) == 14


def test_compare_reads_a_driver_campaign_directory(tmp_path, capsys):
    """A driver directory: the driver's trace keys (no ``phi_e_norm``,
    plus ``K_e_min``) and, once its checkpoint is there, the final fields
    of the checkpoint's complete state."""
    (pa, pb), a, b = _legs(tmp_path)
    d = tmp_path / "campaign"
    d.mkdir()
    np.savez(d / "traces.npz", **{k: a[k] for k in ("t", "phi_M_neuron", "phi_M_glial",
                                                    "K_e_max")}, K_e_min=a["K_e_max"] - 1)
    ref = acc.compare(pa, pb)
    out = acc.compare(d, pb)
    assert out["final_rel_l2"] is None and out["avg_emi_iters"][0] is None
    for k in ("t_final_ms", "max_dphi_M_neuron_mV", "max_dphi_M_glial_mV", "max_rel_dK_e"):
        assert out[k] == ref[k]
    # the checkpoint layout (io.save_checkpoint): c rows K, Cl, Na by the
    # astrocyte scenario's order, and the rest of a state
    c0 = np.stack([a["final_c_K_0"], np.zeros(40), a["final_c_Na_0"]])
    c1 = np.stack([a["final_c_K_1"], np.zeros(30), np.zeros(30)])
    np.savez(d / "ckpt.npz", c__0=c0, c__1=c1, phi__0=a["final_phi_0"],
             phi_M__1=a["final_phi_M_1"], phi_M__2=a["final_phi_M_2"], scalar__t=30.0)
    out = acc.compare(d, pb)
    capsys.readouterr()
    assert out["final_rel_l2"] == ref["final_rel_l2"]


def _config(tmp_path, name, solver):
    cfg = yaml.safe_load(BASELINE_YML.read_text())
    cfg["solver"] = solver
    path = tmp_path / f"{name}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / max(float(np.max(np.abs(b))), 1e-300))


def test_run_leg_matches_jax_run_leg(tmp_path, capsys):
    """15 float64 steps at mesh_n 10 (the source gate on from the 12th)."""
    jax_out, port_out = tmp_path / "jax.npz", tmp_path / "port.npz"
    _jax_tool("accuracy_flagship")._run_leg("f64", 1.5, jax_out, 10)
    port = acc.run_leg("f64", 1.5, port_out, mesh_n=10, device="cpu",
                       config=_config(tmp_path, "per_ion", {"knp_batched": False}))
    capsys.readouterr()
    with np.load(jax_out) as f:
        ref = {k: f[k] for k in f.files}
    assert set(port) == set(ref)
    assert len(ref["t"]) == 3 and len(ref["it_emi"]) == 15
    np.testing.assert_array_equal(port["it_emi"], ref["it_emi"])
    np.testing.assert_array_equal(port["it_knp"], ref["it_knp"])
    assert ref["K_e_max"][-1] > ref["K_e_max"][0] + 1.0  # the source is on
    for k in (*acc.TRACE_KEYS, *(f"final_{k}" for k in acc.FINAL_KEYS)):
        assert port[k].shape == ref[k].shape, k
        assert _rel(port[k], ref[k]) <= 1e-9, k


class _Crash(Exception):
    pass


def test_a_leg_resumed_from_its_checkpoint_equals_an_unbroken_one(tmp_path, monkeypatch,
                                                                  capsys):
    """mesh_n 8, 15 steps (the gate on from the 12th), a checkpoint and a
    synchronous EMI refresh every 5 steps: the leg stops at step 7 and
    resumes from its step-5 checkpoint (refreshing as the unbroken leg
    did at step 5); every array but the wall time is bitwise equal."""
    from knpemi_tpu_torch.sim.stepper import Simulation

    cfg = _config(tmp_path, "refresh", {"mg_refresh_every": 5, "mg_refresh_async": False})
    kw = dict(mesh_n=8, device="cpu", config=cfg, checkpoint_every=5)
    gold = acc.run_leg("f64", 1.5, tmp_path / "gold.npz", **kw)
    step = Simulation.step

    def crashing(self, state):
        if int(state.step) == 7:
            raise _Crash
        return step(self, state)

    monkeypatch.setattr(Simulation, "step", crashing)
    with pytest.raises(_Crash):
        acc.run_leg("f64", 1.5, tmp_path / "split.npz", **kw)
    monkeypatch.setattr(Simulation, "step", step)
    assert not (tmp_path / "split.npz").exists()
    split = acc.run_leg("f64", 1.5, tmp_path / "split.npz", **kw)
    assert "resumed at step 5" in capsys.readouterr().err
    assert set(split) == set(gold)
    for k in gold:
        if k != "wall":
            np.testing.assert_array_equal(split[k], gold[k], err_msg=k)
    assert len(gold["it_emi"]) == 15 and gold["K_e_max"][-1] > gold["K_e_max"][0] + 1.0
    # a finished leg resumes to a no-op
    again = acc.run_leg("f64", 1.5, tmp_path / "split.npz", **kw)
    np.testing.assert_array_equal(again["final_c_K_0"], gold["final_c_K_0"])


def test_committed_record_is_what_the_tools_compute(capsys):
    campaign = RECORD / "campaign_300ms"
    out = summ.summarize(campaign, RECORD / "campaign.log")
    assert json.loads((RECORD / "summary.json").read_text()) == out
    assert out["n_saves"] == 600 and abs(out["t_final_ms"] - 300.0) < 0.05
    env = acc.compare(campaign, RECORD / rec_mod.TWIN_NPZ)
    capsys.readouterr()
    committed = json.loads((RECORD / "envelope.json").read_text())
    for k, v in env.items():
        if k != "final_rel_l2":  # the checkpoint is not committed
            assert committed["compare"][k] == v, k
    with np.load(RECORD / rec_mod.TWIN_NPZ) as f:
        assert not [k for k in f.files if k.startswith("final_")]
        assert committed["twin_iterations"] == rec_mod.leg_iterations(f)
        assert len(f["it_emi"]) == 3000 and len(f["t"]) == 600
    against = json.loads((RECORD / "against_jax.json").read_text())
    assert against["side_by_side"] == rec_mod.side_by_side(
        out, json.loads((JAX_CAMPAIGN / "summary.json").read_text()))
    assert against["port_calls"] == rec_mod.calls_from_log(RECORD / "campaign.log")
    assert sum(c["refreshes_installed"] for c in against["port_calls"]) == 29
