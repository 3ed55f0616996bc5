"""Planted faults: an entry whose answers are broken underneath the
harness, so that a run shows whether the comparison catches them.  The
tests plant them on the CPU; ``readings.py --fault`` on the card at a
cell's own size."""

from __future__ import annotations

import numpy as np
import torch

#: the faults a cell of these configurations can have
FAULTS = ("unchanged", "half", "altered")


class Fault:
    """Wraps an entry; ``how`` is one of ``FAULTS``:

    * ``unchanged``: the solve returns its start (flat voltages, generation
      at the middle of its range, no multipliers) and claims success;
    * ``half`` (batches of two or more): half of the batch left out, the
      other half's answers standing in for it;
    * ``altered``: one answer altered where it is produced (vm of the
      first lane's second bus moved by 1e-3 p.u.).
    """

    def __init__(self, entry, how: str):
        if how not in FAULTS:
            raise ValueError(f"no fault {how!r}; known: {FAULTS}")
        self.entry, self.how = entry, how

    def request(self, loads):
        ans = {k: (v.clone() if torch.is_tensor(v) else np.array(v, copy=True))
               for k, v in self.entry.request(loads).items()}
        if self.how == "unchanged":
            x0 = self._start(ans["x"])
            ans["x"][:] = x0
            for k in ("mult_g", "mult_x_L", "mult_x_U"):
                ans[k][:] = 0
            ans["status"][:] = 0
        elif self.how == "half":
            half = ans["x"].shape[0] // 2
            if not half:
                raise ValueError("a batch of one has no half to leave out")
            for k in ans:
                ans[k][half:] = ans[k][:half]
        elif self.how == "altered":
            nb = self.entry.nb if hasattr(self.entry, "nb") else self.entry.case.nb
            ans["x"][0, nb + 1] += 1e-3
        return ans

    def _start(self, like):
        """The model's starting point, as the solve would begin from it."""
        nlp = getattr(self.entry, "nlp", None)
        if nlp is None:  # an entry that builds its model per request
            nlp = self.entry.model(self.entry.case)
        x0 = nlp.x0
        if torch.is_tensor(like):
            return torch.as_tensor(x0, dtype=like.dtype, device=like.device)
        return np.asarray(x0, dtype=like.dtype)
