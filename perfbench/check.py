"""The comparison that decides ``correct``.

The program's state at chunk boundaries (the host copies the window's
observer receives) is put into the reference's dof numbering through the
parent mesh's vertex ids; the reference advances the state at one
boundary over the chunk's steps, and the program's state at the next
boundary is held against it.  Three numbers, each the largest over the
sampled chunks:

  phi   max |phi_prog - phi_ref| / max |phi_ref| over every subdomain's
        dofs, each side less its mean (the EMI system is pure Neumann:
        phi is defined up to a constant that no later phase reads);
  c     the largest, over subdomains and ions (the eliminated one too),
        of max |c_prog - c_ref| / max |c_ref|;
  ode   the largest, over membranes and state variables, of
        max |y_prog - y_ref| / max |y_ref|.

The reference reads the program's state only as the starting point of
each chunk: every operator, source and parameter it applies it derives
from the configuration itself.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

NUMBERS = ("phi", "c", "ode")


class Numbering:
    """Maps the program's dof order to the reference's, subdomain by
    subdomain and membrane by membrane, by parent vertex id."""

    def __init__(self, prog_geom, ref_geom):
        self.sub, self.mem = {}, {}
        for name, prog, ref in (("subdomain", prog_geom.subdomains, ref_geom.subdomains),
                                ("membrane", prog_geom.membranes, ref_geom.membranes)):
            if sorted(prog) != sorted(ref):
                raise ValueError(f"the program's {name} tags {sorted(prog)} are not "
                                 f"the configuration's {sorted(ref)}")
            out = self.sub if name == "subdomain" else self.mem
            for t in ref:
                pv = np.asarray(prog[t].vertices, np.int64)
                rv = ref[t].vertices
                pos = np.searchsorted(rv, pv)
                if len(pv) != len(rv) or not np.array_equal(rv[np.minimum(pos, len(rv) - 1)], pv):
                    raise ValueError(f"{name} {t}: the program's dofs are not the "
                                     "configuration's vertices")
                out[t] = torch.as_tensor(pos)

    def state(self, s, device, dtype=torch.float64) -> dict:
        """A program state (a ``SimState`` of host tensors) in the reference's
        numbering, as the reference's state dict."""
        def put(v, pos, axis):
            v = v.to(device=device, dtype=dtype)
            out = torch.empty_like(v)
            idx = pos.to(device)
            if axis == 0:
                out[idx] = v
            else:
                out[:, idx] = v
            return out
        return dict(
            c={t: put(v, self.sub[t], 1) for t, v in s.c.items()},
            phi={t: put(v, self.sub[t], 0) for t, v in s.phi.items()},
            phi_M={m: put(v, self.mem[m], 0) for m, v in s.phi_M.items()},
            ode={m: put(v, self.mem[m], 0) for m, v in s.ode_states.items()},
            t=float(s.t), step=int(s.step))


def _rel(a, b):
    den = float(torch.max(torch.abs(b)))
    return float(torch.max(torch.abs(a - b))) / (den if den > 0 else 1.0)


def numbers(got: dict, ref: dict) -> Dict[str, float]:
    """The three numbers of ``got`` against ``ref`` (reference state dicts)."""
    cat = lambda d: torch.cat([d[t] for t in sorted(d)])
    pg, pr = cat(got["phi"]), cat(ref["phi"])
    out = dict(phi=_rel(pg - pg.mean(), pr - pr.mean()))
    out["c"] = max(_rel(got["c"][t][k], ref["c"][t][k])
                   for t in ref["c"] for k in range(ref["c"][t].shape[0]))
    out["ode"] = max(_rel(got["ode"][m][:, j], ref["ode"][m][:, j])
                     for m in ref["ode"] for j in range(ref["ode"][m].shape[1]))
    return out


def fails(nb: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether a chunk's numbers pass any of their limits."""
    return any(nb[k] > limits[k] for k in NUMBERS)


def worst(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: max(a.get(k, 0.0), b.get(k, 0.0)) for k in NUMBERS}


def bf16_store(x):
    """The control's storage: every phase's output rounded to bfloat16."""
    return x.to(torch.bfloat16).to(x.dtype)
