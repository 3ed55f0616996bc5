"""hs071 for both packages, and the shifted starts of its lanes.

Four variables in [1, 5], x1 x2 x3 x4 >= 25, sum of squares = 40;
f* = 17.0140173.  Shared by ``test_torch_chunked.py`` and by
``scripts/torch_anchor.py --tests``, which stores the JAX package's lanes
for that test.
"""

import numpy as np

B = 6
X0 = np.array([1.0, 5.0, 5.0, 1.0])


def hs071(build, lib):
    """hs071 through a package's ``build_nlp``; ``lib`` is its array module."""
    return build(
        lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
        X0,
        x_l=np.ones(4),
        x_u=np.full(4, 5.0),
        eq=lambda x: lib.stack([x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 - 40.0]),
        ineq=lambda x: lib.stack([25.0 - x[0] * x[1] * x[2] * x[3]]),
        name="hs071",
    )


def starts(step):
    """``B`` starts, lane i at ``X0 + step * i`` clipped to the bounds."""
    return np.stack([np.clip(X0 + step * i, 1.0, 5.0) for i in range(B)])
