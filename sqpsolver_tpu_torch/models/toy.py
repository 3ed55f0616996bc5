"""The reference's golden-value toy problem (torch port of ``models/toy.py``).

    min  x^2 + x
    s.t. x^2 - x == 2,   x*y == 1,   x*y >= 0,   x >= -2 (linear row, first)

Known solution x* = -1, y* = -1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nlp import NLP


def toy_nlp() -> NLP:
    inf = np.inf

    def f(z):
        x = z[0]
        return x * x + x

    def g(z):
        x, y = z[0], z[1]
        return torch.stack([x, x * x - x, x * y, x * y])

    return NLP(
        f=f,
        g=g,
        n=2,
        m=4,
        x_l=np.array([-inf, -inf]),
        x_u=np.array([inf, inf]),
        g_l=np.array([-2.0, 2.0, 1.0, 0.0]),
        g_u=np.array([inf, 2.0, 1.0, inf]),
        x0=np.zeros(2),
        num_linear=1,
        name="toy_ext_solver",
    )
