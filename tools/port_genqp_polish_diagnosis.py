"""Which elements the float32 GenQP polish rejects, in the JAX package and in
the PyTorch port, on the same problems (Experiment 1's GenQP column: the
box of ``create_qp_data`` as G = [-I; I], ``GenQPConfig(tol,
symmetrize=False)``).

    JAX_PLATFORMS=cpu python tools/port_genqp_polish_diagnosis.py \\
        [--batch 16] [--n 1000] [--tol 1e-5]

Neither package returns the polish's acceptance mask, so an element counts
as polished where its x differs from the same solve's without polish.  Two
problem sets, each given to both packages as the same numpy arrays: the
port's ``create_qp_data`` on the CPU and the JAX package's, seed 0.  Prints
one line per set and package (iterations, converged, polished), the
elements on which the two packages disagree, and for each element the
port rejects, which of its acceptance tests failed (``models/genqp.py``
``_polish``: the polished point's violation against max(the iterate's,
eps_abs), and the smallest AL multiplier against the noise floor).  Runs
on the CPU in under a minute at the default size.
"""

import argparse

import numpy as np


def _masks(solve, args, cfg, replace):
    plain = solve(*args, config=replace(cfg, polish=False))
    pol = solve(*args, config=replace(cfg, polish=True))
    x0, x1 = np.asarray(plain.x), np.asarray(pol.x)
    return (int(pol.iterations), np.asarray(pol.converged),
            np.any(x0 != x1, axis=-1))


def _port_reasons(genqp):
    """Wrap the port's ``_polish`` to record, per element, the two sides of
    each acceptance test it makes; returns the records' list."""
    from lqp_py_tpu_torch.models._polish import al_lam_threshold

    seen, orig, pen = [], genqp._polish, genqp.gen_penalty_polish

    def polish(Qs, ps, As, bs, Gs, hs, x, *rest):
        pols = []

        def penalty(*a, **kw):
            pols.append(pen(*a, **kw))
            return pols[-1]

        genqp.gen_penalty_polish = penalty
        try:
            out = orig(Qs, ps, As, bs, Gs, hs, x, *rest)
        finally:
            genqp.gen_penalty_polish = pen
        eps_abs, ops = rest[-4], rest[-1]

        def viol(xv):
            v = (ops.mv(Gs, xv) - hs).clamp(min=0.0).amax(dim=-1)
            if As is not None:
                v = v.maximum((ops.mv(As, xv) - bs).abs().amax(dim=-1))
            return v

        seen.append({"viol_pol": viol(pols[0].x),
                     "viol_bound": viol(x).clamp(min=eps_abs),
                     "lam_min": pols[0].lam.amin(dim=-1),
                     "lam_floor": -max(eps_abs, al_lam_threshold(x.dtype))})
        return out

    genqp._polish = polish
    return seen


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--tol", type=float, default=1e-5)
    ns = ap.parse_args()

    import dataclasses

    import jax.numpy as jnp
    import torch

    import lqp_py_tpu as J
    import lqp_py_tpu_torch as T
    from lqp_py_tpu_torch.models import genqp
    from lqp_py_tpu.utils.generators import create_qp_data as j_data
    from lqp_py_tpu_torch.utils.generators import create_qp_data as t_data

    sets = {
        "port create_qp_data (CPU stream)": [
            np.asarray(v) for v in t_data(ns.n, ns.batch, seed=0,
                                          dtype=torch.float32,
                                          device="cpu")[:6]],
        "JAX create_qp_data": [np.asarray(v, np.float32) for v in
                               j_data(ns.n, ns.batch, seed=0,
                                      dtype=jnp.float32)[:6]],
    }
    seen = _port_reasons(genqp)
    for name, (Q, p, A, b, lb, ub) in sets.items():
        n = Q.shape[-1]
        G = np.broadcast_to(np.concatenate([-np.eye(n), np.eye(n)]),
                            (ns.batch, 2 * n, n)).astype(np.float32)
        h = np.concatenate([-lb, ub], axis=-1)
        args = (Q, p, A, b, G, h)
        j = _masks(J.solve_qp_gen, [jnp.asarray(a) for a in args],
                   J.GenQPConfig(eps_abs=ns.tol, eps_rel=ns.tol,
                                 symmetrize=False), dataclasses.replace)
        t = _masks(T.solve_qp_gen, [torch.from_numpy(np.array(a))
                                    for a in args],
                   T.GenQPConfig(eps_abs=ns.tol, eps_rel=ns.tol,
                                 symmetrize=False), dataclasses.replace)
        for pkg, (it, conv, moved) in (("JAX", j), ("port", t)):
            print(f"{name}, {pkg}: {it} iterations, {int(conv.sum())}/"
                  f"{ns.batch} converged, {int(moved.sum())}/{ns.batch} "
                  f"polished, rejected {np.flatnonzero(~moved).tolist()}")
        print(f"{name}: the packages disagree on elements "
              f"{np.flatnonzero(j[2] != t[2]).tolist()}")
        r = seen[-1]
        for e in np.flatnonzero(~t[2]):
            print(f"  port element {e}: violation polished "
                  f"{r['viol_pol'][e].item():.3e} against "
                  f"{r['viol_bound'][e].item():.3e}; smallest multiplier "
                  f"{r['lam_min'][e].item():.3e} against "
                  f"{r['lam_floor']:.3e}")


if __name__ == "__main__":
    main()
