"""Probe of the kNN distance's last bit, the port against the JAX package
on the CPU, at a size the unit tests do not run:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_knn_probe.py

Prints, for 2^20 random float32 rows and 64 random targets: how many
``d2`` values of ``geomesa_tpu_torch.ops.knn.knn_d2`` differ from the JAX
package's fused kNN formula (``DeviceIndex.knn``: ``dx = (x - qx) *
cos(radians(qy))``, ``d2 = dx*dx + dy*dy``, jitted in float32) when both
use the JAX package's float32 cos factor; for how many targets that
factor differs from the port's ``lon_factor``; how many ``d2`` values
then differ, and how many places of the full nearest-first rankings. Then, over 2^20 random latitudes, how often XLA's float32
``cos(radians(lat))`` differs from ``torch.cos`` and from the port's
factor. ``tests/test_torch_knn.py`` checks the first count at 2^16 rows.
"""

import numpy as np
import torch

from geomesa_tpu.jaxconf import force_cpu_devices, require_x64
from geomesa_tpu_torch.ops import knn as knn_ops

N_ROWS = 1 << 20
N_TARGETS = 64


def main() -> None:
    force_cpu_devices(1)  # before jax is imported
    require_x64()
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _reference_d2(x, y, q):
        """The distance of the JAX package's fused kNN function, verbatim."""
        dx = (x - q[0]) * jnp.cos(jnp.radians(q[1]))
        dy = y - q[1]
        return dx * dx + dy * dy

    rng = np.random.default_rng(7)
    x = rng.uniform(-180, 180, N_ROWS).astype(np.float32)
    y = rng.uniform(-90, 90, N_ROWS).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    same_c = own_c = c_differs = swapped = 0
    for _ in range(N_TARGETS):
        px, py = float(rng.uniform(-180, 180)), float(rng.uniform(-89.9, 89.9))
        want = np.asarray(_reference_d2(x, y, jnp.asarray(np.array([px, py, 45.0], np.float32))))

        def differing(c):
            got = knn_ops.knn_d2(xt, yt, knn_ops.query_vector(px, py, 45.0, c, "cpu")).numpy()
            return int((got != want).sum())

        def ranking(c):
            q = knn_ops.query_vector(px, py, 400.0, c, "cpu")
            return knn_ops.knn(xt, yt, q, N_ROWS)[0]

        c_ref = float(np.float32(jnp.cos(jnp.radians(jnp.float32(py)))))
        c_own = knn_ops.lon_factor(py)
        same_c += differing(c_ref)
        own_c += differing(c_own)
        c_differs += int(c_ref != c_own)
        if c_ref != c_own:
            swapped += int((ranking(c_ref) != ranking(c_own)).sum())
    print(f"{N_ROWS} rows x {N_TARGETS} targets: d2 differing with the JAX package's factor "
          f"{same_c}; targets whose factor differs from lon_factor {c_differs}; d2 differing "
          f"with lon_factor {own_c}; positions of the full rankings (every row, nearest "
          f"first) that differ between the two factors {swapped}")
    lat = rng.uniform(-90, 90, N_ROWS).astype(np.float32)
    xla = np.asarray(jnp.cos(jnp.radians(jnp.asarray(lat))))
    tor = torch.cos(torch.deg2rad(torch.from_numpy(lat))).numpy()
    own = np.cos(np.radians(lat.astype(np.float64))).astype(np.float32)
    print(f"{N_ROWS} latitudes: XLA float32 cos differs from torch.cos on "
          f"{(xla != tor).mean():.4f}, from lon_factor's rounding on {(xla != own).mean():.4f}")


if __name__ == "__main__":
    main()
