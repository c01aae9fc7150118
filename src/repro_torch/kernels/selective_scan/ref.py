"""Plain PyTorch version of the selective scan: the step recurrence.

Counterpart of ``src/repro/kernels/selective_scan/ref.py``. Every step
computes ``da = exp(dt_t * a)``, ``h = da * h + (dt_t * x_t) * b_t`` and
``y_t = sum_N h * c_t`` in float32, from ``h_0 = 0``, one op at a time in
that order, the sum over N taken state by state from n = 0 up. The CUDA
kernel follows the same order per element, so the two differ only where
the device's ``exp`` does.
"""

from __future__ import annotations

import torch


def _scan(dt, b, c, x, a) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (y [B,S,di] float32, h_S [B,di,N] float32)."""
    B, S, di = dt.shape
    dtf, bf, cf, xf, af = (t.float() for t in (dt, b, c, x, a))
    h = torch.zeros((B, di, a.shape[-1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t, :, None] * af)               # [B,di,N]
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        hc = h * cf[:, t, None, :]
        y = hc[..., 0]
        for n in range(1, hc.shape[-1]):
            y = y + hc[..., n]
        ys.append(y)
    y = (torch.stack(ys, 1) if ys else
         torch.zeros((B, 0, di), dtype=torch.float32, device=dt.device))
    return y, h


def selective_scan_ref(dt, b, c, x, a) -> torch.Tensor:
    """dt/x [B,S,di], b/c [B,S,N], a [di,N] -> y [B,S,di] in dt's dtype."""
    return _scan(dt, b, c, x, a)[0].to(dt.dtype)


def selective_scan_state_ref(dt, b, c, x, a) -> torch.Tensor:
    """Final state ``h_S [B,di,N]`` (float32) of the same recurrence: the
    decode carry."""
    return _scan(dt, b, c, x, a)[1]
