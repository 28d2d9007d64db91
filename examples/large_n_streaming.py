"""Large-N streaming fit — past the reference's memory wall.

The reference documents a practical single-node envelope of N≈10-15k
(``README.md:69``; ≈5N² doubles peak, ``INSTALL.md:75``).  The streaming
path never materializes the N×N kernel: the truncated eigensystem and all
marginal effects come from tile-wise K@V products (``ops/matvec.py``).

Run (a GPU recommended):  python examples/large_n_streaming.py [N]
"""
import sys
import time

import numpy as np

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))  # run from a repo checkout


import bigkrls_tpu as bk

N = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
P = 20
rng = np.random.default_rng(0)
X = rng.normal(size=(N, P))
y = np.sin(X[:, 0]) + X @ (0.2 * np.ones(P)) + rng.normal(size=N)

t = time.time()
model = bk.fit(y, X, neig=500, streaming=True,
               which_derivatives=[0, 1, 2], noisy=True)
print(f"\nN={N:,} kernel-free fit in {time.time() - t:.1f}s "
      f"(R2={model.R2:.3f}, lastkeeper={model.lastkeeper})")
print("phase timings:", model.timings)
print(bk.summary(model))
