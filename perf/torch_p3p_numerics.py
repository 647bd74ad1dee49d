"""P3P numerics of the JAX package and of the PyTorch port, on the CPU.

On the random problems of tests/test_clip_loc.py (default 200, seed 0; the
same bearings fed to both packages):

1. how many problems each solver recovers (a valid root within 5e-2 of the
   true pose, the JAX test's gate): the JAX package as shipped (jitted, its
   fp32 closed-form Kabsch of 3 points), the JAX package with an SVD Kabsch,
   and the port (float64 Kabsch);
2. how far the port's poses are from the JAX package's (with the SVD
   Kabsch, eager), binned by each root's relative condition number in the
   quartic: fp32 P3P agrees to about 2e-7 x kappa in depth;
3. how far the JAX package's own jitted and eager programs are apart.

Run: JAX_PLATFORMS=cpu python perf/torch_p3p_numerics.py [N]
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

from instance_based_loc_tpu.ops import p3p as jp3p  # noqa: E402
from instance_based_loc_tpu_torch.ops import p3p as tp3p  # noqa: E402
from test_torch_clip_loc import (K, _problems, _quartic64,  # noqa: E402
                                 _svd_kabsch)


def main(n: int = 200) -> None:
    true, world, pixels = _problems(n)
    bearings = np.asarray(jax.vmap(lambda px: jp3p.pixel_bearings(
        px, jnp.asarray(K)))(jnp.asarray(pixels)))
    args = (jnp.asarray(world), jnp.asarray(bearings))
    shipped = [np.asarray(x) for x in
               jax.jit(jax.vmap(jp3p.p3p_grunert))(*args)]
    jp3p.kabsch_transform = _svd_kabsch
    jit = [np.asarray(x) for x in jax.jit(jax.vmap(jp3p.p3p_grunert))(*args)]
    eager = [np.asarray(x) for x in jax.vmap(jp3p.p3p_grunert)(*args)]
    port = [x.numpy() for x in tp3p.p3p_grunert(
        torch.from_numpy(world), torch.from_numpy(bearings.copy()))]

    def recovered(poses, valid):
        e = np.abs(poses - true[:, None]).max((-1, -2))
        return int((np.where(valid, e, np.inf).min(1) < 5e-2).sum())
    print(f"recovered of {n}: JAX shipped {recovered(*shipped)}, JAX with "
          f"an SVD Kabsch {recovered(*jit)} (eager {recovered(*eager)}), "
          f"port {recovered(*port)}")

    both = port[1] & eager[1] & jit[1]
    kappa = np.zeros(both.shape)
    for s, r in zip(*np.nonzero(both)):
        c = _quartic64(world[s], bearings[s])
        cam = (world[s].astype(np.float64) - port[0][s, r, :3, 3]) \
            @ port[0][s, r, :3, :3]
        v = np.linalg.norm(cam[2]) / np.linalg.norm(cam[0])
        kappa[s, r] = (np.sum(np.abs(c) * v ** np.arange(4, -1, -1))
                       / max(abs(v * np.polyval(np.polyder(c), v)), 1e-30))
    d_port = np.abs(port[0] - eager[0]).max((-1, -2))
    d_jax = np.abs(jit[0] - eager[0]).max((-1, -2))
    print("kappa bin          roots  max|port - JAX eager|  "
          "max|JAX jit - JAX eager|")
    for lo, hi in ((0, 1e1), (1e1, 1e2), (1e2, 1e3), (1e3, 1e4), (1e4, 1e9)):
        sel = both & (kappa >= lo) & (kappa < hi)
        if sel.any():
            print(f"[{lo:7.0e}, {hi:7.0e})  {int(sel.sum()):5d}  "
                  f"{d_port[sel].max():21.3e}  {d_jax[sel].max():24.3e}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 200)
