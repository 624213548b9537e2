"""Forward-mode jacobians that several threads may take at once.

``torch.func.jacfwd`` keeps forward AD's current level in a module-level
variable of ``torch.autograd.forward_ad``: a thread that leaves its level
while another thread is inside ``jacfwd`` resets that thread's level,
whose next dual tensor then raises.  Under asynchronous mapping the
tracking thread (relocalization's PnP) and the mapping worker (the
server's pose-graph optimisation, and its Sim3 refinement on the CPU)
both differentiate, so every jacobian of the port is taken here, one at
a time.
"""

from __future__ import annotations

import threading

import torch

_lock = threading.Lock()


def jacfwd(f, x: torch.Tensor, has_aux: bool = False):
    """``torch.func.jacfwd(f, has_aux=has_aux)(x)`` under the lock."""
    with _lock:
        return torch.func.jacfwd(f, has_aux=has_aux)(x)
