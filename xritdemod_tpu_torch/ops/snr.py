"""RMS-ratio SNR estimate of a block, the GNU Radio golden model's figure.

Counterpart of `xritdemod_tpu/ops/snr.py::snr_estimate_db`: the AGC output
feeds two filters, the RRC matched filter (in-band signal and noise) and a
high-pass above the symbol rate (out-of-band noise only), and the estimate is
`10 log10(P_rrc / P_hpf)` of their mean powers over the block.  Both are
valid-region correlations with no history carried: the estimate is a
diagnostic, not a sample-accurate path, and has no Pallas kernel in the
reference.  The correlations are `F.conv1d` in full float32 (the context of
`ops/fir.py`, whatever the global TF32 flags say).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xritdemod_tpu_torch.ops.fir import _float32_conv
from xritdemod_tpu_torch.utils.cplx import CF32

__all__ = ["snr_estimate_db"]


@torch.no_grad()
def snr_estimate_db(x: CF32, rrc_taps, hpf_taps) -> torch.Tensor:
    """`(..., T)` AGC-output block -> `(...)` estimated SNR in dB; taps are
    float32 tensors or arrays.  Powers are floored at 1e-20 as the
    reference floors them."""
    lead, T = x.re.shape[:-1], x.re.shape[-1]
    dev = x.re.device

    def power(taps) -> torch.Tensor:
        w = torch.as_tensor(taps, dtype=torch.float32, device=dev)[None, None, :]
        with _float32_conv():
            re = F.conv1d(x.re.reshape(-1, 1, T), w)[:, 0, :]
            im = F.conv1d(x.im.reshape(-1, 1, T), w)[:, 0, :]
        return torch.mean(re * re + im * im, dim=-1).reshape(lead)

    p_sig, p_noise = power(rrc_taps), power(hpf_taps)
    return 10.0 * torch.log10(torch.clamp(p_sig, min=1e-20) / torch.clamp(p_noise, min=1e-20))
