"""SSM and recurrent blocks: Mamba (selective SSM), xLSTM (mLSTM, sLSTM).

Counterpart of ``repro/models/ssm.py``, the same arithmetic in torch ops.
Each block has the reference's four entry points:
  ``*_init``        — parameters (float32, the reference's tree);
  ``*_forward``     — a full sequence, chunkwise where the recurrence
                      allows it (Mamba, mLSTM): a loop over chunks carrying
                      the float32 state, so the largest transient is one
                      chunk's;
  ``*_decode``      — one token against the recurrent state (O(1) a token:
                      the sub-quadratic path of long_500k);
  ``*_init_state``  — the zero state of a batch.

The reference's deviations are kept: Mamba without its short depthwise
convolution; mLSTM chunkwise in log space with the ``max(|q·n|, 1)``
normaliser (the m-state stabiliser only in the sequential decode); sLSTM
the exact exponential-gating recurrence with the m-state stabiliser and
per-head recurrent matrices, a loop over time steps.

Mamba's intra-chunk scan: the reference runs ``lax.associative_scan`` over
``(decay, inc)`` pairs with the combine ``(a, b)·(a', b') = (a·a',
b·a' + b')``. PyTorch has no associative scan, so the port runs a doubling
(Hillis–Steele) scan of the same combine over the chunk axis, log2(chunk)
passes; it never divides a cumulative product of decays back out, which
would underflow on long chunks. The two scans group the products
differently, so they agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import ModelConfig, Params

_PAD_LOG = -30.0  # padded steps: dt (Mamba) and log i (mLSTM) of -30 add nothing
SLSTM_M_INIT = -30.0  # sLSTM's stabiliser m in a fresh state


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``-softplus(-x)``, as the reference writes ``log σ(x)``."""
    return -F.softplus(-x)


# ===================================================================== #
# Mamba (diagonal selective SSM)
# ===================================================================== #
def mamba_init(generator: torch.Generator | None, cfg: ModelConfig, *, device) -> Params:
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.d_inner or d
    n = ssm.d_state
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": common.dense_init(generator, d, 2 * di, device=device),
        "w_bcdt": common.dense_init(generator, di, 2 * n + 1, device=device),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=device),
        "a_log": torch.log(a).expand(di, n).clone(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": common.dense_init(generator, di, d, device=device),
    }


def _scan_chunk(decay: torch.Tensor, inc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over axis 1 of ``(decay, inc)`` pairs under the
    combine ``(a, b)·(a', b') = (a·a', b·a' + b')``, by doubling: after the
    pass of offset ``o`` each step holds the product of the ``2·o`` steps
    up to it."""
    aa, bb = decay, inc
    o = 1
    while o < aa.shape[1]:
        aa, bb = (torch.cat([aa[:, :o], aa[:, :-o] * aa[:, o:]], dim=1),
                  torch.cat([bb[:, :o], torch.addcmul(bb[:, o:], bb[:, :-o], aa[:, o:])], dim=1))
        o *= 2
    return aa, bb


def mamba_forward(x: torch.Tensor, params: Params, cfg: ModelConfig,
                  h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,T,d] → (y [B,T,d], h_T [B,di,N] float32). Chunkwise: each
    chunk's [B, chunk, di, N] decays and increments are made inside the
    loop, never for the whole sequence."""
    ssm = cfg.ssm
    di = ssm.d_inner or cfg.d_model
    n = ssm.d_state
    b, t, _ = x.shape
    u, z = torch.chunk(common.dense(x, params["in_proj"]), 2, dim=-1)
    bcdt = common.dense(u, params["w_bcdt"]).to(torch.float32)  # [B,T,2n+1]
    b_t, c_t, dt = bcdt[..., :n], bcdt[..., n:2 * n], bcdt[..., -1:]
    a = -torch.exp(params["a_log"])                              # [di,N]
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device) if h0 is None else h0
    chunk = min(ssm.chunk, t)
    pad = (-t) % chunk
    u_p, dt_p, b_p, c_p = u, dt, b_t, c_t
    if pad:
        u_p = F.pad(u, (0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad), value=_PAD_LOG)
        b_p = F.pad(b_t, (0, 0, 0, pad))
        c_p = F.pad(c_t, (0, 0, 0, pad))
    ys = []
    for s in range(0, t + pad, chunk):
        u_c, dt_c = u_p[:, s:s + chunk], dt_p[:, s:s + chunk]
        b_c, c_c = b_p[:, s:s + chunk], c_p[:, s:s + chunk]
        delta = F.softplus(dt_c + params["dt_bias"]) + 1e-4          # [B,C,di]
        decay = torch.exp(delta[..., None] * a)                       # [B,C,di,N]
        inc = (delta * u_c.to(torch.float32))[..., None] * b_c[:, :, None, :]
        aa, bb = _scan_chunk(decay, inc)
        hs = aa * h[:, None] + bb                                     # [B,C,di,N]
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, c_c))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :t]
    y = y + u.to(torch.float32) * params["d_skip"]
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    return common.dense(y, params["out_proj"]), h


def mamba_decode(x: torch.Tensor, h: torch.Tensor, params: Params,
                 cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,1,d]; h [B,di,N] → (y [B,1,d], h')."""
    n = cfg.ssm.d_state
    u, z = torch.chunk(common.dense(x, params["in_proj"]), 2, dim=-1)
    u1, z1 = u[:, 0], z[:, 0]
    bcdt = common.dense(u1, params["w_bcdt"]).to(torch.float32)
    b_t, c_t, dt = bcdt[..., :n], bcdt[..., n:2 * n], bcdt[..., -1:]
    delta = F.softplus(dt + params["dt_bias"]) + 1e-4                 # [B,di]
    a = -torch.exp(params["a_log"])
    decay = torch.exp(delta[..., None] * a)                           # [B,di,N]
    uf = u1.to(torch.float32)
    h = h * decay + (delta * uf)[..., None] * b_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_t) + uf * params["d_skip"]
    y = (y * F.silu(z1.to(torch.float32))).to(x.dtype)
    return common.dense(y, params["out_proj"])[:, None], h


def mamba_init_state(batch: int, cfg: ModelConfig, *, device) -> torch.Tensor:
    di = cfg.ssm.d_inner or cfg.d_model
    return torch.zeros((batch, di, cfg.ssm.d_state), dtype=torch.float32, device=device)


# ===================================================================== #
# mLSTM (matrix-memory LSTM, chunkwise parallel)
# ===================================================================== #
def mlstm_init(generator: torch.Generator | None, cfg: ModelConfig, *, device) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": common.dense_init(generator, d, d, device=device),
        "wk": common.dense_init(generator, d, d, device=device),
        "wv": common.dense_init(generator, d, d, device=device),
        "w_gates": common.dense_init(generator, d, 2 * h, device=device),  # (input, forget)
        "wo": common.dense_init(generator, d, d, device=device),
        "skip": torch.ones((d,), dtype=torch.float32, device=device),
    }


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)  # [B,H,T,Dh]


def mlstm_forward(x: torch.Tensor, params: Params, cfg: ModelConfig,
                  state: tuple | None = None) -> tuple[torch.Tensor, tuple]:
    """x [B,T,d] → (y [B,T,d], (S [B,H,Dh,Dh], n [B,H,Dh]) float32)."""
    h = cfg.n_heads
    b, t, d = x.shape
    dh = d // h
    q = _heads(common.dense(x, params["wq"]), h).to(torch.float32) * dh**-0.5
    k = _heads(common.dense(x, params["wk"]), h).to(torch.float32)
    v = _heads(common.dense(x, params["wv"]), h).to(torch.float32)
    gates = common.dense(x, params["w_gates"]).to(torch.float32)     # [B,T,2H]
    log_i = _log_sigmoid(gates[..., :h]).transpose(1, 2)             # [B,H,T]
    log_f = _log_sigmoid(gates[..., h:]).transpose(1, 2)

    chunk = min(cfg.ssm.chunk if cfg.ssm else 128, t)
    pad = (-t) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, pad), value=_PAD_LOG)
        log_f = F.pad(log_f, (0, pad))
    if state is None:
        s = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    else:
        s, n = state
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(0, t + pad, chunk):
        qb, kb, vb = q[:, :, c:c + chunk], k[:, :, c:c + chunk], v[:, :, c:c + chunk]
        li, lf = log_i[..., c:c + chunk], log_f[..., c:c + chunk]
        l_cum = torch.cumsum(lf, dim=-1)                             # Σ log f up to t
        # intra-chunk decay matrix D[t, s] = exp(L_t - L_s + log i_s), s ≤ t
        diff = l_cum[..., :, None] - l_cum[..., None, :] + li[..., None, :]
        w = torch.where(tri, torch.exp(diff), 0.0)                   # [B,H,C,C]
        scores = torch.einsum("bhtd,bhsd->bhts", qb, kb) * w
        y_intra = torch.einsum("bhts,bhsd->bhtd", scores, vb)
        n_intra = torch.einsum("bhts,bhsd->bhtd", w, kb)
        decay_t = torch.exp(l_cum)                                   # [B,H,C]
        y_inter = torch.einsum("bhtd,bhde->bhte", qb, s) * decay_t[..., None]
        n_inter = n[:, :, None] * decay_t[..., None]
        y = y_intra + y_inter
        n_t = n_intra + n_inter
        denom = torch.clamp(torch.abs(torch.einsum("bhtd,bhtd->bht", qb, n_t)), min=1.0)
        ys.append(y / denom[..., None])
        tot = l_cum[..., -1]
        rev = torch.exp(tot[..., None] - l_cum + li)                 # the increments' decays
        s = s * torch.exp(tot)[..., None, None] + torch.einsum("bhtd,bhte,bht->bhde", kb, vb, rev)
        n = n * torch.exp(tot)[..., None] + torch.einsum("bhtd,bht->bhd", kb, rev)
    y = torch.cat(ys, dim=2)[:, :, :t]
    y = y.transpose(1, 2).reshape(b, t, d).to(x.dtype)
    y = y + x * params["skip"].to(x.dtype)
    return common.dense(y, params["wo"]), (s, n)


def mlstm_decode(x: torch.Tensor, state: tuple, params: Params,
                 cfg: ModelConfig) -> tuple[torch.Tensor, tuple]:
    """One step of the recurrence. x [B,1,d]; state (S, n)."""
    h = cfg.n_heads
    b, _, d = x.shape
    dh = d // h
    s, n = state
    q = common.dense(x, params["wq"]).reshape(b, h, dh).to(torch.float32) * dh**-0.5
    k = common.dense(x, params["wk"]).reshape(b, h, dh).to(torch.float32)
    v = common.dense(x, params["wv"]).reshape(b, h, dh).to(torch.float32)
    gates = common.dense(x, params["w_gates"]).reshape(b, 2 * h).to(torch.float32)
    i_g = torch.exp(_log_sigmoid(gates[:, :h]))
    f_g = torch.exp(_log_sigmoid(gates[:, h:]))
    s = s * f_g[..., None, None] + i_g[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = n * f_g[..., None] + i_g[..., None] * k
    y = torch.einsum("bhd,bhde->bhe", q, s)
    denom = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), min=1.0)[..., None]
    y = (y / denom).reshape(b, 1, d).to(x.dtype)
    y = y + x * params["skip"].to(x.dtype)
    return common.dense(y, params["wo"]), (s, n)


def mlstm_init_state(batch: int, cfg: ModelConfig, *, device) -> tuple:
    h = cfg.n_heads
    dh = cfg.d_model // h
    return (torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((batch, h, dh), dtype=torch.float32, device=device))


# ===================================================================== #
# sLSTM (scalar-memory LSTM with exponential gating; sequential)
# ===================================================================== #
def slstm_init(generator: torch.Generator | None, cfg: ModelConfig, *, device) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        "w_x": common.dense_init(generator, d, 4 * d, device=device),   # z, i, f, o
        "r_h": common.normal((h, dh, 4 * dh), dh**-0.5, generator=generator, device=device),
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=device),
        "wo": common.dense_init(generator, d, d, device=device),
    }


def slstm_forward(x: torch.Tensor, params: Params, cfg: ModelConfig,
                  state: tuple | None = None) -> tuple[torch.Tensor, tuple]:
    """x [B,T,d] → (y [B,T,d], (c, n, h, m) each [B,d] float32): a loop
    over the T steps."""
    b, t, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    wx = common.dense(x, params["w_x"]).to(torch.float32) + params["b"]
    c, n, hid, m = slstm_init_state(b, cfg, device=x.device) if state is None else state
    r_h = params["r_h"]
    ys = []
    for step in range(t):
        rh = torch.einsum("bhd,hde->bhe", hid.reshape(b, nh, dh).to(torch.float32), r_h)
        # per head (z, i, f, o): both terms as [B, nh, 4, dh]
        pre = wx[:, step].reshape(b, nh, 4, dh) + rh.reshape(b, nh, 4, dh)
        z = torch.tanh(pre[:, :, 0]).reshape(b, d)
        log_i = pre[:, :, 1].reshape(b, d)
        log_f = _log_sigmoid(pre[:, :, 2]).reshape(b, d)
        o = torch.sigmoid(pre[:, :, 3]).reshape(b, d)
        m_new = torch.maximum(log_f + m, log_i)
        i_p = torch.exp(log_i - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        hid = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        ys.append(hid)
    y = torch.stack(ys, dim=1).to(x.dtype)
    return common.dense(y, params["wo"]), (c, n, hid, m)


def slstm_decode(x: torch.Tensor, state: tuple, params: Params,
                 cfg: ModelConfig) -> tuple[torch.Tensor, tuple]:
    return slstm_forward(x, params, cfg, state)


def slstm_init_state(batch: int, cfg: ModelConfig, *, device) -> tuple:
    """(c, n, h, m): zeros, and m at -30."""
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return (z, z.clone(), z.clone(), z + SLSTM_M_INIT)
