"""MLP layers: gated (SwiGLU/GeGLU), plain (GELU/ReLU²), and MoE.

Counterpart of ``repro/models/mlp.py``. The MoE layer is the reference's
GShard/Switch layer with a fixed expert capacity: a float32 router, top-k
with renormalised gates, each (token, k)'s position within its expert by
a stable sort, capacity drops, a scatter into ``[E, capacity, d]``, three
batched expert products, the gather and gate-weighted combine, the Switch
load-balancing auxiliary loss, and the shared experts (dense MLPs applied
to every token beside the routed path).

``moe_forward`` dispatches as the reference's: under a mesh
(``distributed.sharding.use_mesh``) whose ``model`` axis (size > 1)
divides the expert count it takes the expert-parallel path
(:func:`_moe_forward_ep`, the reference's ``shard_map``), else the dense
path (:func:`_moe_forward_dense`). The reference pads the expert axis to a
multiple of 16 for its TPU mesh; the padded experts are unreachable (the
router has no logit for them), so the port leaves the padding out.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding as shard_lib
from repro_torch.launch.mesh import data_axes
from repro_torch.models import common
from repro_torch.models.common import ModelConfig, Params


def init(
    generator: torch.Generator | None, cfg: ModelConfig, kind: str, d_ff: int | None = None,
    *, device,
) -> Params:
    """Drawn in the reference's order of keys: up, down, then gate."""
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    p = {"up": common.dense_init(generator, d, ff, device=device),
         "down": common.dense_init(generator, ff, d, device=device)}
    if kind in ("swiglu", "geglu"):
        p["gate"] = common.dense_init(generator, d, ff, device=device)
    return p


def forward(x: torch.Tensor, params: Params, kind: str) -> torch.Tensor:
    up = common.dense(x, params["up"])
    if kind in ("swiglu", "geglu"):
        h = common.activation(common.dense(x, params["gate"]), kind) * up
    else:
        h = common.activation(up, kind)
    return common.dense(h, params["down"])


# --------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------- #
def moe_init(generator: torch.Generator | None, cfg: ModelConfig, kind: str, *,
             device) -> Params:
    m = cfg.moe
    d, fe = cfg.d_model, m.d_expert_ff
    scale = d**-0.5
    p: Params = {
        "router": common.dense_init(generator, d, m.n_experts, scale=scale, device=device),
        "w_gate": common.normal((m.n_experts, d, fe), scale, generator=generator, device=device),
        "w_up": common.normal((m.n_experts, d, fe), scale, generator=generator, device=device),
        "w_down": common.normal((m.n_experts, fe, d), fe**-0.5, generator=generator,
                                device=device),
    }
    if m.n_shared:
        fs = m.d_shared_ff or m.d_expert_ff
        p["shared"] = init(generator, cfg, kind, d_ff=fs * m.n_shared, device=device)
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    cap = int(m.capacity_factor * tokens * m.top_k / m.n_experts)
    return max(8, ((cap + 7) // 8) * 8)  # 8-aligned, nonzero


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row, largest first, equal values in the
    order of their index, as ``lax.top_k`` breaks ties (a stable
    descending sort; ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def positions_in_expert(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, k)'s rank among the choices of its expert, in (token,
    k) order: a stable sort of the flat choices, then each one's distance
    from its expert's first place (``searchsorted``). int32 ``[T, K]``."""
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(n_experts, device=flat_e.device,
                                                      dtype=sorted_e.dtype))
    ranks_sorted = torch.arange(flat_e.numel(), device=flat_e.device) - start[sorted_e]
    pos_flat = torch.empty_like(ranks_sorted)
    pos_flat[order] = ranks_sorted
    return pos_flat.reshape(expert_idx.shape).to(torch.int32)


def moe_route(xt: torch.Tensor, params: Params, cfg: ModelConfig) -> dict:
    """The routing of tokens ``xt [T, d]``: ``probs`` float32 [T, E],
    ``gates`` [T, K] (renormalised), ``experts`` [T, K], ``positions``
    int32 [T, K] within each expert, ``keep`` [T, K] (position under the
    capacity) and ``capacity``. The router runs in float32 on float32
    inputs (bf16 logits would make the choice hang on 1-ulp noise)."""
    m = cfg.moe
    logits = common.dense(xt.to(torch.float32), params["router"])       # [T,E]
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, m.top_k)                              # [T,K]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    pos = positions_in_expert(experts, m.n_experts)
    cap = _capacity(xt.shape[0], cfg)
    return {"probs": probs, "gates": gates, "experts": experts, "positions": pos,
            "keep": pos < cap, "capacity": cap}


def moe_forward(x: torch.Tensor, params: Params, cfg: ModelConfig,
                kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] → (out [B,S,d], the Switch auxiliary loss, float32 scalar).

    The expert-parallel path under a :func:`~repro_torch.distributed.
    sharding.use_mesh` mesh whose ``model`` axis (size > 1) divides the
    expert count, else the dense path. Serving drops the auxiliary loss;
    training adds it."""
    mesh = shard_lib.current_mesh()
    m = cfg.moe
    if (mesh is not None and "model" in mesh.axis_names and mesh.shape["model"] > 1
            and m.n_experts % mesh.shape["model"] == 0):
        return _moe_forward_ep(x, params, cfg, kind, mesh)
    return _moe_forward_dense(x, params, cfg, kind)


def _moe_forward_ep(x: torch.Tensor, params: Params, cfg: ModelConfig, kind: str,
                    mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's expert-parallel path, its positions run one after
    another in this process. Tokens stay on their data shard (the batch
    split over the data axes) and each shard routes its own tokens, with
    the capacity of its own token count; each model rank runs the kept
    choices of its ``E / tp`` experts, and the ranks' partial sums meet in
    the reference's ``psum``. The ranks' experts together are all the
    experts, so a shard's output is the dense path's over the shard's
    rows, which this runs shard by shard. The auxiliary loss is each
    shard's own, averaged over the data shards (the ``pmean``). Raises
    ``ValueError`` when the batch does not split over the data axes."""
    n_data = math.prod(mesh.shape[a] for a in data_axes(mesh))
    if x.shape[0] % n_data:
        raise ValueError(f"batch {x.shape[0]} does not split over {n_data} data shards of mesh "
                         f"{dict(mesh.shape)}")
    parts = [_moe_forward_dense(xs, params, cfg, kind) for xs in x.chunk(n_data)]
    return torch.cat([o for o, _ in parts]), torch.stack([a for _, a in parts]).mean()


def _moe_forward_dense(x: torch.Tensor, params: Params, cfg: ModelConfig,
                       kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's dense dispatch path (no mesh, or an expert count
    the ``model`` axis does not divide): each kept (token, k) is written
    to its expert's slot of a ``[E·cap + 1, d]`` buffer (dropped ones to
    the last row, which no expert reads), one scatter per k, so no
    ``[T·K, d]`` copy of the tokens is made; the expert weights are cast
    to x's dtype as they are read."""
    m = cfg.moe
    b, s, d = x.shape
    tokens = b * s
    xt = x.reshape(tokens, d)
    r = moe_route(xt, params, cfg)
    cap, e = r["capacity"], m.n_experts
    slot = r["experts"].to(torch.int64) * cap + r["positions"]               # [T,K]
    slot = torch.where(r["keep"], slot, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    for k in range(m.top_k):
        buf.index_copy_(0, slot[:, k], xt)
    buf = buf[:-1].reshape(e, cap, d)
    dt = x.dtype
    h_g = torch.bmm(buf, params["w_gate"].to(dt))
    h_u = torch.bmm(buf, params["w_up"].to(dt))
    out_buf = torch.bmm(common.activation(h_g, kind) * h_u, params["w_down"].to(dt))
    del buf, h_g, h_u
    gathered = out_buf.reshape(e * cap, d)[torch.where(r["keep"], slot, 0)]   # [T,K,d]
    gathered = torch.where(r["keep"][..., None], gathered, 0)
    out = torch.sum(gathered * r["gates"][..., None].to(dt), dim=1)
    # Switch load balance: E · Σ_e f_e · P_e over the choices' density
    flat_e = r["experts"].reshape(-1)
    density = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.ones(flat_e.shape, dtype=torch.float32, device=x.device)) / tokens
    aux = e * torch.sum(density * torch.mean(r["probs"], dim=0)) / m.top_k
    if "shared" in params:
        out = out + forward(xt, params["shared"], kind)
    return out.reshape(b, s, d), aux
