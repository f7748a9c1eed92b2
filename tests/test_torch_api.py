"""The port's public API against the JAX package's.

* for ``knpemi_tpu`` and each of its subpackages, every name of its
  ``__all__`` is in the port's counterpart's ``__all__`` and resolves;
  the only names left out are the orbax checkpoint pair, whose
  counterpart is the ``torch.distributed.checkpoint`` pair;
* ``interpolate_to_membrane``, ``membrane_potential_from_phi``,
  ``create_functions_emi`` / ``create_functions_knp``, ``SubdomainDef``
  and the ``MembraneModel`` accessors against JAX's on seeded numpy
  inputs, float64, to 1e-14 relative; the setters return new arrays;
* ``save_checkpoint_dcp`` / ``load_checkpoint_dcp``: a state and its
  metadata round-trip bit for bit, without a process group.
"""

import dataclasses
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

SUBPACKAGES = ["", "io", "mesh", "models", "ops", "parallel", "sim", "solvers", "systems",
               "utils"]
# JAX-only, with their counterpart in the port named beside them
ORBAX = {"save_checkpoint_orbax": "save_checkpoint_dcp",
         "load_checkpoint_orbax": "load_checkpoint_dcp"}
TOL = 1e-14


def _mod(root, sub):
    return importlib.import_module(f"{root}.{sub}" if sub else root)


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top level")
def test_every_public_name_of_the_jax_package_is_in_the_port(sub):
    jmod, tmod = _mod("knpemi_tpu", sub), _mod("knpemi_tpu_torch", sub)
    missing = set(jmod.__all__) - set(ORBAX) - set(tmod.__all__)
    assert not missing, f"{sub or 'top level'}: {sorted(missing)}"
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None


def test_the_orbax_pair_is_the_only_checkpoint_function_left_out():
    from knpemi_tpu.io import checkpoint as jck
    from knpemi_tpu_torch.io import checkpoint as tck

    public = lambda m: {n for n, v in vars(m).items()
                        if inspect.isfunction(v) and not n.startswith("_")
                        and v.__module__ == m.__name__}
    assert public(jck) - public(tck) == set(ORBAX)
    assert set(ORBAX.values()) <= public(tck)


def _geometries():
    from knpemi_tpu.mesh import idealized_2d_mesh as jmesh
    from knpemi_tpu.ops import build_geometry as jbuild
    from knpemi_tpu_torch.mesh import idealized_2d_mesh as tmesh
    from knpemi_tpu_torch.ops import build_geometry as tbuild

    return jbuild(jmesh(1)), tbuild(tmesh(1))


def _close(port, ref):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.max(np.abs(port - ref)) <= TOL * max(np.max(np.abs(ref)), 1e-300)


@pytest.mark.parametrize("as_dict", [False, True], ids=["MembraneSpace", "dict"])
def test_traces_and_membrane_potential_match_jax(as_dict):
    from knpemi_tpu.systems import coupling as jc
    from knpemi_tpu_torch.systems import coupling as tc

    gj, gt = _geometries()
    rng = np.random.default_rng(3)
    n_e, n_i = gt.subdomains[0].n_dofs, gt.subdomains[1].n_dofs
    u_e, u_i = rng.standard_normal((2, n_e)), rng.standard_normal((2, n_i))
    for m in gt.membranes:
        mj, mt = gj.membranes[m], gt.membranes[m]
        if as_dict:
            mj = {"mem_to_ecs": mj.mem_to_ecs, "mem_to_ics": mj.mem_to_ics}
            mt = {"mem_to_ecs": mt.mem_to_ecs, "mem_to_ics": mt.mem_to_ics}
        ref = jc.interpolate_to_membrane(jnp.asarray(u_e), jnp.asarray(u_i), mj)
        out = tc.interpolate_to_membrane(torch.from_numpy(u_e), torch.from_numpy(u_i), mt)
        for o, r in zip(out, ref):
            _close(o, r)
        # numpy inputs gather as well
        for o, r in zip(tc.interpolate_to_membrane(u_e, u_i, mt), ref):
            _close(o, r)
        _close(tc.membrane_potential_from_phi(torch.from_numpy(u_e[0]),
                                              torch.from_numpy(u_i[0]), mt),
               jc.membrane_potential_from_phi(jnp.asarray(u_e[0]), jnp.asarray(u_i[0]), mj))


def test_create_functions_match_jax(monkeypatch):
    from knpemi_tpu.systems import create_functions_emi as jemi, create_functions_knp as jknp
    from knpemi_tpu.systems import Ion as JIon
    from knpemi_tpu_torch.systems import (
        Ion as TIon, create_functions_emi as temi, create_functions_knp as tknp,
    )

    gj, gt = _geometries()
    ions = [("K", 1.0), ("Cl", -1.0), ("Na", 1.0)]
    (pj, mj), (pt, mt) = jemi(gj), temi(gt, device="cpu")
    for ref, out in ((pj, pt), (mj, mt)):
        assert list(out) == list(ref)
        for k in ref:
            assert out[k].dtype == torch.float64 and not out[k].any()
            _close(out[k], ref[k])
    cj = jknp(gj, [JIon(n, z, {0: 1.0, 1: 1.0}) for n, z in ions])
    ct = tknp(gt, [TIon(n, z, {0: 1.0, 1: 1.0}) for n, z in ions], dtype=torch.float32,
              device="cpu")
    assert list(ct) == list(cj)
    for k in cj:
        assert ct[k].dtype == torch.float32 and tuple(ct[k].shape) == cj[k].shape
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: temi(gt), lambda: tknp(gt, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_subdomain_def_matches_jax():
    from knpemi_tpu.systems import SubdomainDef as J
    from knpemi_tpu_torch.systems import SubdomainDef as T

    fields = lambda c: [(f.name, f.type, f.default) for f in dataclasses.fields(c)]
    assert fields(T) == fields(J)
    kw = dict(tag=1, name="neuron", membrane_tags=[1, 2], ode_models={1: "hh"})
    assert dataclasses.asdict(T(**kw)) == dataclasses.asdict(J(**kw))
    assert T(0, "ecs").membrane_tags == [] and T(0, "ecs").ode_models == {}


@pytest.mark.parametrize("model", ["hh", "glial"])
def test_membrane_model_accessors_match_jax(model):
    from knpemi_tpu.models import MembraneModel as JM, get_model as jget
    from knpemi_tpu_torch.models import MembraneModel as TM, get_model as tget

    gj, gt = _geometries()
    mj, mt = JM(jget(model), gj.membranes[1]), TM(tget(model), gt.membranes[1])
    rng = np.random.default_rng(5)
    n = mt.n_dofs
    states = rng.standard_normal((n, len(mt.ode.state_names)))
    params = rng.standard_normal((n, len(mt.ode.param_names)))
    vals = rng.standard_normal(n)
    sj, st = jnp.asarray(states), torch.from_numpy(states.copy())
    pj, pt = jnp.asarray(params), torch.from_numpy(params.copy())
    for name in mt.ode.state_names:
        _close(mt.get_state(st, name), mj.get_state(sj, name))
        out = mt.set_state(st, name, torch.from_numpy(vals))
        _close(out, mj.set_state(sj, name, jnp.asarray(vals)))
        assert out is not st
    for name in mt.ode.param_names:
        _close(mt.get_param(pt, name), mj.get_param(pj, name))
        out = mt.set_param(pt, name, torch.from_numpy(vals))
        _close(out, mj.set_param(pj, name, jnp.asarray(vals)))
    if "V" in mt.ode.state_names:
        out = mt.set_membrane_potential(st, torch.from_numpy(vals))
        _close(out, mj.set_membrane_potential(sj, jnp.asarray(vals)))
        _close(mt.get_membrane_potential(out), vals)
    # out of place: the inputs are as they were
    np.testing.assert_array_equal(st.numpy(), states)
    np.testing.assert_array_equal(pt.numpy(), params)


def _stepped_state():
    from knpemi_tpu_torch.sim import build_idealized

    sim = build_idealized(dim=2, resolution=1, dtype=torch.float64, device="cpu")
    state, *_ = sim.run(sim.init_state(), 2)
    return state


def test_dcp_checkpoint_round_trip_is_bitwise(tmp_path):
    from knpemi_tpu_torch.io import (
        load_checkpoint, load_checkpoint_dcp, save_checkpoint, save_checkpoint_dcp,
    )
    from knpemi_tpu_torch.systems.types import SimState

    state = _stepped_state()
    trace = np.random.default_rng(1).standard_normal(7)
    meta = dict(n_saves=3, trace_t=trace, note="leg 1")
    save_checkpoint_dcp(tmp_path / "dcp", state, **meta)
    assert (tmp_path / "dcp").is_dir()
    back, got = load_checkpoint_dcp(tmp_path / "dcp", device="cpu")
    save_checkpoint(tmp_path / "s.npz", state, n_saves=3, trace_t=trace)
    npz, _ = load_checkpoint(tmp_path / "s.npz", device="cpu")
    for f in SimState.__dataclass_fields__:
        a, b, c = getattr(state, f), getattr(back, f), getattr(npz, f)
        if isinstance(a, dict):
            assert list(b) == list(a)
            pairs = [(a[k], b[k], c[k]) for k in a]
        else:
            pairs = [(a, b, c)]
        for x, y, z in pairs:
            assert y.dtype == x.dtype and y.device.type == "cpu", f
            assert torch.equal(x, y) and torch.equal(y, z), f
    assert int(got["n_saves"]) == 3 and got["note"] == "leg 1"
    np.testing.assert_array_equal(got["trace_t"], trace)
    # a dtype asked for on load, as the npz loader gives it
    b32, _ = load_checkpoint_dcp(tmp_path / "dcp", device="cpu", dtype=torch.float32)
    n32, _ = load_checkpoint(tmp_path / "s.npz", device="cpu", dtype=torch.float32)
    assert all(torch.equal(b32.c[k], n32.c[k]) for k in n32.c)
    assert b32.c[0].dtype == torch.float32
