"""Feed-forward blocks: SwiGLU, GELU MLP, and top-k MoE.

The MoE is the reference's sort-free dense dispatch: each token's top-k
entries are scattered into per-expert capacity buffers (position in
expert from a running one-hot cumsum over the token-major entries;
overflow dropped), the experts run as one batched product over the
expert axis, and the results are gathered back weighted by the
renormalized router probabilities. The reference's expert FFN is a
batched einsum outside any Pallas kernel, so this is plain PyTorch
(``torch.bmm``) on every device.

Under model parallelism (``DTensor`` tokens under a bound mesh) the same
`moe_forward` runs on each rank's tokens; see its docstring.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.sharding import constrain
from repro_torch.shards import (check_rows_placed, from_local, row_partials,
                                shard_range, to_local, whole)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype: torch.dtype, device=None):
    if activation == "swiglu":
        return {
            "wi": dense_init(gen, d_model, d_ff, dtype, device),
            "wg": dense_init(gen, d_model, d_ff, dtype, device),
            "wo": dense_init(gen, d_ff, d_model, dtype, device),
        }
    return {
        "wi": dense_init(gen, d_model, d_ff, dtype, device),
        "wo": dense_init(gen, d_ff, d_model, dtype, device),
    }


def mlp_forward(p, x, activation: str):
    """Under a bound mesh the Megatron placements are stated: the input
    whole over "model" (gathered from a sequence split), the hidden split
    over "model" on its inner dim, the output's partial sums reduced."""
    x = constrain(x, "batch", None, None)
    if activation == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return constrain(constrain(h, "batch", None, "model") @ p["wo"],
                     "batch", None, None)


# ----------------------------------------------------------------------- MoE

def init_moe(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int,
             dtype: torch.dtype, device=None):
    def stack(fan_in, fan_out):
        return torch.stack([dense_init(gen, fan_in, fan_out, dtype, device)
                            for _ in range(num_experts)])
    return {
        "router": dense_init(gen, d_model, num_experts, dtype, device),
        "wi": stack(d_model, d_ff),              # (E, D, F)
        "wg": stack(d_model, d_ff),
        "wo": stack(d_ff, d_model),              # (E, F, D)
    }


def top_k_experts(probs, top_k: int):
    """The ``top_k`` largest router probabilities of each row, largest
    first, and their experts; equal probabilities go to the lower expert
    index, as ``lax.top_k`` orders them (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :top_k], idx[:, :top_k]


def moe_route(p, x, *, num_experts: int, top_k: int,
              capacity_factor: float):
    """The router's decisions for the T tokens ``x`` (..., D), in
    token-major order: a dict of the router probabilities ``probs`` (T,
    E) f32, each token's experts ``top_e`` (T, K) and renormalized
    weights ``top_p`` (T, K), the per-expert ``capacity``, and per
    token-major entry (T·K) its buffer ``slot`` (expert · capacity +
    position in expert) and whether it is kept (``keep``; an entry past
    its expert's capacity is dropped and points at the expert's last
    slot). ``probs_x`` holds the probabilities laid out as ``x`` (...,
    E). On a ``DTensor`` the decisions are made on every rank from the
    all-gathered probabilities: ``probs`` and the rest are whole and
    plain, ``probs_x`` is placed as ``x``."""
    probs_x = torch.softmax((x @ p["router"]).float(), dim=-1)
    probs = whole(probs_x, x).reshape(-1, num_experts)
    t = probs.shape[0]
    top_p, top_e = top_k_experts(probs, top_k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    cap = int(max(top_k * t * capacity_factor / num_experts, top_k))
    flat_e = top_e.reshape(-1)
    onehot = F.one_hot(flat_e, num_experts)
    # the running count of each expert over the entries, scanned along
    # the rows of the (E, T·K) transpose (one row per expert in parallel)
    running = torch.cumsum(onehot.t().contiguous(), dim=1).t()
    pos = (running - onehot).gather(1, flat_e[:, None])[:, 0]
    keep = pos < cap
    return {"probs": probs, "probs_x": probs_x, "top_e": top_e,
            "top_p": top_p, "capacity": cap,
            "slot": flat_e * cap + torch.where(keep, pos, cap - 1),
            "keep": keep}


def moe_forward(p, x, *, num_experts: int, top_k: int,
                capacity_factor: float = 1.25):
    """x: (B, S, D) -> ((B, S, D), aux), aux the Switch-style router
    load-balance loss (float32). The capacity is that of the call's B·S
    tokens.

    The body runs on this rank's tokens (all of them on a plain tensor):
    under a bound mesh the router decides on the all-gathered (T, E)
    probabilities, so capacity and positions in expert are the global
    ones; each rank scatters its own entries into the dispatch buffer,
    whose partial sums are reduced onto the capacity axis ("batch"), the
    experts run with their inner dim over "model", and each rank gathers
    its tokens' rows back from the all-gathered expert outputs. Tokens
    are flattened on the local shards only (a ``DTensor`` flatten of a
    sequence-split gradient has no even form)."""
    b, s, d = x.shape
    x = constrain(x, "batch", None, None)
    check_rows_placed(x, "moe_forward")
    r = moe_route(p, x, num_experts=num_experts, top_k=top_k,
                  capacity_factor=capacity_factor)
    cap = r["capacity"]
    lo, n = shard_range(x, 0)                   # this rank's batch rows
    rows = slice(lo * s * top_k, (lo + n) * s * top_k)
    slot, keep = r["slot"][rows], r["keep"][rows]
    xf = to_local(x).reshape(n * s, d)
    tok_id = torch.arange(n * s, device=xf.device).repeat_interleave(top_k)

    # dispatch: every kept entry owns its slot (the reference adds the
    # dropped ones to their expert's last slot as zero rows, which leaves
    # it as it is); here they go to one extra row, which is discarded
    n_slots = num_experts * cap
    buf = torch.zeros((n_slots + 1, d), dtype=x.dtype, device=xf.device)
    buf[torch.where(keep, slot, n_slots)] = xf[tok_id]
    buf = from_local(buf[:n_slots].reshape(num_experts, cap, d), x,
                     row_partials(x))
    buf = constrain(buf, None, "batch", None)
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    h = constrain(h, None, "batch", "model")
    out_e = constrain(torch.bmm(h, p["wo"]), None, "batch", None)
    out_e = whole(out_e, x).reshape(n_slots, d)

    # combine, in the model dtype: each token's k contributions in order
    gathered = torch.where(keep[:, None], out_e[slot], 0)
    contrib = (gathered * r["top_p"].reshape(-1, 1)[rows].to(x.dtype)
               ).reshape(n * s, top_k, d)
    out = torch.zeros((n * s, d), dtype=x.dtype, device=xf.device)
    for j in range(top_k):
        out = out + contrib[:, j]

    me = r["probs_x"].mean(dim=(0, 1))                           # (E,)
    frac = F.one_hot(r["top_e"][:, 0], num_experts).float().mean(dim=0)
    aux = num_experts * torch.sum(me * frac)
    return from_local(out.reshape(n, s, d), x), aux
