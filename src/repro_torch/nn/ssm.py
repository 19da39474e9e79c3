"""State-space / linear-recurrence cells: Mamba2 (SSD) and RWKV6 (Finch)
(counterpart of `repro.nn.ssm`).

Each has two forms, as in the reference:
  * a chunked form for prefill: within a chunk, matrix products; across
    chunks, the state is carried by a Python loop (the reference's
    `jax.lax.scan`);
  * a recurrent step for decode, O(1) state.

The chunk length is the reference's rule: ``l = min(chunk, S)``, then
lowered until it divides S (a prime S above the chunk runs chunks of
1).  Decays, the recurrences and their states are fp32 under any
compute dtype (RWKV6's float64 under float64).  RWKV6 keeps chunk 16:
its log-decay a step is clipped to at least -5, so the factored
intra-chunk exponent stays within ``16 * 5 = 80 < log(fp32 max) ~
88``.

On a mesh each cell splits over the "model" axis (`split_`, tensor
parallelism where the axis divides its heads), as the reference's rules
place its "heads" and "mlp" leaves there:

* `Mamba2` by SSM heads: the fused ``in_proj`` keeps this rank's heads'
  columns of z, x and dt and all of B and C (one group: ``d_state``
  columns each, computed on every rank), the conv its x channels and all
  the B/C ones, ``out_proj`` its rows (the products summed over the
  axis), the state its heads.  The reference cuts the fused columns
  evenly at rest and regathers them around its split; this head-aligned
  cut is the same function with B and C held on every rank
  (`fused_cuts` records it for `partition.ModelLayout`).
* `RWKV6TimeMix` by heads (``cut == "heads"``): r, k, v and g by
  columns, o by rows, the wkv state and ``bonus_u`` by heads; the
  token-shift mix and the decay LoRA stay whole (the decay read at this
  rank's channels).  Where the axis does not divide the heads but does
  ``head_dim`` (rwkv6-3b's 40 heads of 64 at 16) it is cut by value
  columns (``cut == "value"``), as the reference cuts the wkv state
  there (its value dim, "mlp" -> "model", `repro/models/rwkv.py:95-101`):
  r, k, v, g and o stay cut at rest by the fused columns and rows the
  reference's resolver gives them, and are gathered whole at each call
  (`Linear` ``rest_cut``); each rank takes columns ``[j q, (j + 1) q)``
  of every head (``q = head_dim / M``, ``value_dim``) of v and g, the
  same rows of o, and keeps the state ``[B, H, dk, q]``.  r, k, the
  decay and ``bonus_u`` are read whole, so every gradient but v's, g's
  and o's columns is a part of a sum over the value columns: the
  weights cut at rest take the gather's reduce-scatter backward, and
  the whole leaves are summed over "model" (`read_in_part`).  Where the
  axis divides neither, the mix computes whole on every rank, its
  weights still cut at rest where the axis divides their width (the
  weights, not the activations, cross the axis;
  `repro_torch.nn.attention`).
* `RWKV6ChannelMix` by its hidden width: k by columns, v by rows, and r
  by columns too (the reference's ``("embed", "mlp")``): v's partial
  sums are reduce-scattered to this rank's channels, multiplied by its
  r, and all-gathered (2 calls forward, 2 backward, where a whole r
  would take 1 and 1 and hold all of r on every rank).

The gated norm of Mamba2 and RWKV6's ``ln_x`` normalize across heads
(or value columns) a rank does not hold: their statistics sum over the
axis (`LayerNorm.split_`).  A split cell copies its input into the region
(`collectives.copy_to`), so the leaves it keeps whole but reads in part
(`read_in_part`: the mixes, the LoRAs, ``A_log``, ``D``, ``dt_bias``,
``bonus_u``, the norms' affine parameters) and B/C's columns hold a
part of their gradient on each rank: `MeshTrainStep` sums them over
"model".

Inside a sequence-parallel region (``reduce=False``: the input is the
whole sequence gathered from the ranks' slices, `repro_torch.models`)
each rank's gradient is its part of a sum over the axis: a split cell
reads its input as it is (the gather's backward sums it), a weight cut
at rest is gathered with the reduce-scatter backward, and the RWKV6
channel mix's channel gather reduce-scatters its gradient too (each
rank keeps only its slice of the sequence of the output).  The cells
see the whole sequence, so their token shifts and recurrences are the
whole sequence's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.collectives import (Axis, copy_to,
                                                 fused_slice, gather_at_use,
                                                 reduce_from,
                                                 reduce_scatter_seq)
from repro_torch.nn.layers import LayerNorm, Linear, splits


def chunk_length(chunk: int, s: int) -> int:
    """The largest length <= min(chunk, s) that divides s."""
    n = min(chunk, s)
    while s % n:
        n -= 1
    return n


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

class Mamba2State(NamedTuple):
    ssm: torch.Tensor   # [B, H, P, N]
    conv: torch.Tensor  # [B, K-1, conv_dim] rolling conv buffer


class Mamba2(nn.Module):
    """Mamba2 block (SSD, a scalar A a head, one group)."""

    def __init__(self, d_model: int, *, d_state: int = 64,
                 head_dim: int = 64, expand: int = 2, conv_kernel: int = 4,
                 chunk: int = 128):
        super().__init__()
        self.d_model = d_model
        self.d_inner = expand * d_model
        self.d_state = d_state
        self.head_dim = head_dim
        self.n_heads = self.d_inner // head_dim
        self.conv_kernel = conv_kernel
        self.chunk = chunk
        # in_proj emits [z (gate), x, B, C, dt]
        self.proj_dims = (self.d_inner, self.d_inner, d_state, d_state,
                          self.n_heads)
        self.conv_dim = self.d_inner + 2 * d_state
        self.in_proj = Linear(d_model, sum(self.proj_dims), use_bias=False,
                              kernel_axes=("embed", "mlp"))
        self.out_proj = Linear(self.d_inner, d_model, use_bias=False,
                               kernel_axes=("mlp", "embed"))
        self.conv_w = nn.Parameter(torch.zeros(conv_kernel, self.conv_dim))
        self.conv_b = nn.Parameter(torch.zeros(self.conv_dim))
        self.A_log = nn.Parameter(torch.zeros(self.n_heads))
        self.D = nn.Parameter(torch.zeros(self.n_heads))
        self.dt_bias = nn.Parameter(torch.zeros(self.n_heads))
        self.norm = LayerNorm(self.d_inner, use_bias=False)
        self.axis: Axis | None = None
        self._pieces: dict = {}

    def logical_axes(self) -> dict:
        return {"conv_w": (None, "mlp"), "conv_b": ("mlp",),
                "A_log": (None,), "D": (None,), "dt_bias": (None,)}

    def split_(self, axis: Axis) -> bool:
        """Split by SSM heads over the axis (module docstring); False
        (the layer stays whole) where the axis does not divide them."""
        if not splits(self.n_heads, axis):
            return False
        di, n, h = self.d_inner, self.d_state, self.n_heads
        self._pieces = {"in_proj.w": (1, self._in_pieces()),
                        "conv_w": (1, self._conv_pieces()),
                        "conv_b": (0, self._conv_pieces())}
        for name, (dim, pieces) in self._pieces.items():
            owner, _, leaf = name.rpartition(".")
            mod = self.get_submodule(owner) if owner else self
            p = mod._parameters[leaf]
            with torch.no_grad():
                part = fused_slice(p, dim, pieces, axis)
            mod._parameters[leaf] = nn.Parameter(
                part, requires_grad=p.requires_grad)
        self.out_proj.split_("row", axis)
        self.norm.split_(axis)
        m = axis.size
        self.n_heads, self.d_inner = h // m, di // m
        self.proj_dims = (di // m, di // m, n, n, h // m)
        self.conv_dim = di // m + 2 * n
        self.axis = axis
        return True

    def _in_pieces(self) -> tuple:
        di, n = self.d_inner, self.d_state
        return ((di, True), (di, True), (n, False), (n, False),
                (self.n_heads, True))

    def _conv_pieces(self) -> tuple:
        return ((self.d_inner, True), (self.d_state, False),
                (self.d_state, False))

    def fused_cuts(self) -> dict:
        """{leaf: (dim, pieces)} of the leaves cut by heads within a
        fused dim once split: each piece (width of the whole, cut over
        the axis or held whole by every rank) in order."""
        return dict(self._pieces)

    def read_in_part(self) -> tuple:
        """The leaves whole over the axis that a split layer reads at its
        heads' entries alone (each rank holds a part of their gradient)."""
        if self.axis is None:
            return ()
        return ("A_log", "D", "dt_bias", "norm.scale")

    def _heads(self, p: torch.Tensor) -> torch.Tensor:
        """This rank's heads of a whole per-head leaf."""
        if self.axis is None:
            return p
        return p.narrow(0, self.axis.index * self.n_heads, self.n_heads)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's constants (`repro/nn/ssm.py:55-69`): conv_w
        N(0, 0.1), conv_b 0, A_log log(linspace(1, 16, H)), D 1, dt_bias
        0; the projections and the norm draw their own."""
        with torch.no_grad():
            self.conv_w.normal_(0.0, 0.1, generator=generator)
            self.conv_b.zero_()
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, self.A_log.shape[0], device=self.A_log.device)))
            self.D.fill_(1.0)
            self.dt_bias.zero_()

    # -- helpers -------------------------------------------------------------

    def _split_proj(self, proj: torch.Tensor):
        return torch.split(proj, self.proj_dims, dim=-1)

    def _conv(self, xbc: torch.Tensor, conv_state: torch.Tensor):
        """Causal depthwise conv over time, silu after the bias.  xbc
        [B, S, conv_dim]; the state [B, K-1, conv_dim] goes in front and
        the new one is cast back to the state's dtype."""
        w = self.conv_w.to(xbc.dtype)  # [K, C]
        k = self.conv_kernel
        s = xbc.shape[1]
        padded = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        out = sum(padded[:, i:i + s] * w[i] for i in range(k))
        out = F.silu(out + self.conv_b.to(xbc.dtype))
        new_state = (padded[:, -(k - 1):].to(conv_state.dtype)
                     if k > 1 else conv_state)
        return out, new_state

    def _gated_norm(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.norm(y) * F.silu(z)

    def init_state(self, batch: int, dtype=torch.float32,
                   device=None) -> Mamba2State:
        device = device if device is not None else self.A_log.device
        return Mamba2State(
            ssm=torch.zeros((batch, self.n_heads, self.head_dim,
                             self.d_state), dtype=dtype, device=device),
            conv=torch.zeros((batch, self.conv_kernel - 1, self.conv_dim),
                             dtype=dtype, device=device))

    def _xbc(self, x: torch.Tensor, state: Mamba2State):
        proj = self.in_proj(x)
        z, xr, bmat, cmat, dt = self._split_proj(proj)
        xbc, conv_state = self._conv(torch.cat([xr, bmat, cmat], dim=-1),
                                     state.conv)
        di, n = self.d_inner, self.d_state
        return (z, xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:],
                dt, conv_state)

    # -- chunked (prefill) ---------------------------------------------------

    def forward(self, x: torch.Tensor, state: Mamba2State | None = None,
                reduce: bool = True):
        """x [B, S, d_model] -> ([B, S, d_model], state).  With
        ``reduce=False`` (inside a sequence-parallel region: `x` the
        whole gathered sequence) a split layer reads `x` as it is and
        gives this rank's part of ``out_proj``'s sum over the axis."""
        b, s, _ = x.shape
        if state is None:
            state = self.init_state(b, torch.float32, x.device)
        if reduce:
            x = copy_to(x, self.axis)
        z, xr, bmat, cmat, dt, conv_state = self._xbc(x, state)
        h, p, n = self.n_heads, self.head_dim, self.d_state
        f32 = torch.float32
        dt = F.softplus(dt.to(f32) + self._heads(self.dt_bias).to(f32))
        a = -torch.exp(self._heads(self.A_log).to(f32))  # [H]
        xh = xr.reshape(b, s, h, p).to(f32)

        l = chunk_length(self.chunk, s)
        nc = s // l
        xc = xh.reshape(b, nc, l, h, p)
        dtc = dt.reshape(b, nc, l, h)
        bc = bmat.reshape(b, nc, l, n).to(f32)
        cc = cmat.reshape(b, nc, l, n).to(f32)
        tril = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
        masked = torch.tensor(-1e30, device=x.device)

        ssm = state.ssm
        ys = []
        for c in range(nc):
            xck, dtk, bk, ck = xc[:, c], dtc[:, c], bc[:, c], cc[:, c]
            la = dtk * a  # [B, l, h] log decay a step (negative)
            lcum = torch.cumsum(la, dim=1)  # inclusive
            # intra-chunk: M[t,s] = (C_t . B_s) exp(lcum_t - lcum_s) dt_s,
            # the exponent masked before exp
            cb = torch.einsum("btn,bsn->bts", ck, bk)
            delta = torch.where(tril[None, :, :, None],
                                lcum[:, :, None, :] - lcum[:, None, :, :],
                                masked)
            m = cb[..., None] * torch.exp(delta)
            m = m * dtk[:, None, :, :]
            y_intra = torch.einsum("btsh,bshp->bthp", m, xck)
            # inter-chunk: C_t . (exp(lcum_t) ssm_prev)
            y_inter = torch.einsum("btn,bhpn,bth->bthp", ck, ssm,
                                   torch.exp(lcum))
            rem = torch.exp(lcum[:, -1:, :] - lcum)  # decay from s to end
            upd = torch.einsum("bshp,bsn,bsh->bhpn", xck, bk, rem * dtk)
            ssm = ssm * torch.exp(lcum[:, -1])[..., None, None] + upd
            ys.append(y_intra + y_inter)
        y = torch.stack(ys, dim=1).reshape(b, s, h, p)
        y = y + xh * self._heads(self.D).to(f32)[None, None, :, None]
        y = y.reshape(b, s, self.d_inner).to(x.dtype)
        y = self._gated_norm(y, z)
        return self.out_proj(y, reduce), Mamba2State(ssm, conv_state)

    # -- recurrent decode ----------------------------------------------------

    def decode_step(self, x: torch.Tensor, state: Mamba2State):
        """x [B, 1, d_model] -> ([B, 1, d_model], state)."""
        b = x.shape[0]
        z, xr, bv, cv, dt, conv_state = self._xbc(copy_to(x, self.axis),
                                                  state)
        h, p, n = self.n_heads, self.head_dim, self.d_state
        f32 = torch.float32
        xr = xr.reshape(b, h, p).to(f32)
        bv = bv.reshape(b, n)
        cv = cv.reshape(b, n)
        dt = F.softplus(dt.to(f32)[:, 0]
                        + self._heads(self.dt_bias).to(f32))  # [B, H]
        a = -torch.exp(self._heads(self.A_log).to(f32))
        decay = torch.exp(dt * a)  # [B, H]
        upd = torch.einsum("bhp,bn,bh->bhpn", xr, bv.to(f32), dt)
        ssm = state.ssm * decay[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", cv.to(f32), ssm)
        y = y + xr * self._heads(self.D).to(f32)[None, :, None]
        y = y.reshape(b, 1, self.d_inner).to(x.dtype)
        y = self._gated_norm(y, z)
        return self.out_proj(y), Mamba2State(ssm, conv_state)


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================

class RWKV6TimeMix(nn.Module):
    """RWKV6 time-mix with data-dependent decay."""

    def __init__(self, d_model: int, *, head_dim: int = 64,
                 lora_mix: int = 32, lora_decay: int = 64, chunk: int = 16):
        super().__init__()
        self.d = d_model
        self.head_dim = head_dim
        self.n_heads = d_model // head_dim
        self.lora_mix = lora_mix
        self.lora_decay = lora_decay
        self.chunk = chunk
        d, m = d_model, lora_mix
        self.mu_x = nn.Parameter(torch.zeros(d))
        self.mu = nn.Parameter(torch.zeros(5, d))
        # the fused mixing LoRA of the 5 projections, and the decay LoRA
        self.mix_a = nn.Parameter(torch.zeros(d, 5 * m))
        self.mix_b = nn.Parameter(torch.zeros(5, m, d))
        self.dec_a = nn.Parameter(torch.zeros(d, lora_decay))
        self.dec_b = nn.Parameter(torch.zeros(lora_decay, d))
        self.dec_base = nn.Parameter(torch.zeros(d))
        self.bonus_u = nn.Parameter(torch.zeros(self.n_heads, head_dim))
        ax = ("embed", "heads")
        self.r = Linear(d, d, use_bias=False, kernel_axes=ax)
        self.k = Linear(d, d, use_bias=False, kernel_axes=ax)
        self.v = Linear(d, d, use_bias=False, kernel_axes=ax)
        self.g = Linear(d, d, use_bias=False, kernel_axes=ax)
        self.o = Linear(d, d, use_bias=False, kernel_axes=("heads", "embed"))
        # one LayerNorm over all of d (the reference's, despite its
        # "per-head group norm" comment)
        self.ln_x = LayerNorm(d)
        self.axis: Axis | None = None
        self.cut: str | None = None    # "heads" or "value" once split
        self.value_dim = head_dim      # value columns of a head a rank

    def logical_axes(self) -> dict:
        return {"mu_x": ("embed",), "mu": (None, "embed"),
                "mix_a": ("embed", None), "mix_b": (None, None, "embed"),
                "dec_a": ("embed", None), "dec_b": (None, "embed"),
                "dec_base": ("embed",), "bonus_u": (None, None)}

    def split_(self, axis: Axis) -> bool:
        """Split by heads over the axis, else by value columns where it
        divides ``head_dim`` (module docstring; ``cut`` says which);
        False (the layer computes whole) where it divides neither, its
        projections then cut at rest where it divides their width."""
        if not splits(self.n_heads, axis):
            if splits(self.d, axis):
                for lin in (self.r, self.k, self.v, self.g):
                    lin.split_("column", axis, at_rest=True)
                self.o.split_("row", axis, at_rest=True)
            if not splits(self.head_dim, axis):
                return False
            self.ln_x.split_(axis, groups=self.n_heads)
            self.value_dim = self.head_dim // axis.size
            self.axis, self.cut = axis, "value"
            return True
        for lin in (self.r, self.k, self.v, self.g):
            lin.split_("column", axis)
        self.o.split_("row", axis)
        self.ln_x.split_(axis)
        self.n_heads //= axis.size
        self.axis, self.cut = axis, "heads"
        return True

    def read_in_part(self) -> tuple:
        """The leaves whole over the axis that a split layer reads for
        its heads or value columns alone (each rank holds a part of their
        gradient)."""
        if self.axis is None:
            return ()
        return ("mu_x", "mu", "mix_a", "mix_b", "dec_a", "dec_b",
                "dec_base", "bonus_u", "ln_x.scale", "ln_x.bias")

    def _mine(self, p: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's heads (dim 0 of ``bonus_u``) or channels of a whole
        leaf (all of it under the value cut: every rank reads every
        head's keys)."""
        if self.cut != "heads":
            return p
        n = p.shape[dim] // self.axis.size
        return p.narrow(dim, self.axis.index * n, n)

    def _values(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's value columns of each head of `t`'s dim `dim`
        (heads x head_dim channels) under the value cut."""
        dim %= t.ndim
        q = self.value_dim
        return t.unflatten(dim, (self.n_heads, self.head_dim)).narrow(
            dim + 1, self.axis.index * q, q).flatten(dim, dim + 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's constants (`repro/nn/ssm.py:227-247`): mu_x,
        mu and bonus_u 0, the LoRAs N(0, 0.02), dec_base linspace(-6,
        -0.5, d); the projections and the norm draw their own."""
        with torch.no_grad():
            self.mu_x.zero_()
            self.mu.zero_()
            for lora in (self.mix_a, self.mix_b, self.dec_a, self.dec_b):
                lora.normal_(0.0, 0.02, generator=generator)
            self.dec_base.copy_(torch.linspace(-6.0, -0.5, self.d,
                                               device=self.mu.device))
            self.bonus_u.zero_()

    def _mix(self, x: torch.Tensor, x_prev: torch.Tensor):
        """Token-shift ddlerp -> (xr, xk, xv, xg, xw); x [B, S, d]."""
        xx = x_prev - x
        xxx = x + xx * self.mu_x.to(x.dtype)
        lora = torch.tanh(torch.matmul(xxx, self.mix_a.to(x.dtype)))
        lora = lora.reshape(*x.shape[:-1], 5, self.lora_mix)
        delta = torch.einsum("...fm,fmd->...fd", lora,
                             self.mix_b.to(x.dtype))
        mu = self.mu.to(x.dtype) + delta  # [..., 5, d]
        return tuple(x + xx * mu[..., i, :] for i in range(5))

    def _decay(self, xw: torch.Tensor) -> torch.Tensor:
        """The log-decay, fp32: -exp(clip(base + lora(xw), -20, 1.609)),
        in [-5, 0)."""
        f32 = torch.promote_types(xw.dtype, torch.float32)
        lw = torch.matmul(torch.tanh(torch.matmul(xw.to(f32),
                                                  self.dec_a.to(f32))),
                          self._mine(self.dec_b, 1).to(f32))
        return -torch.exp(torch.clamp(self._mine(self.dec_base, 0).to(f32)
                                      + lw, -20.0, 1.609))

    def _proj(self, lin: Linear, x: torch.Tensor, reduce: bool,
              values: bool = False) -> torch.Tensor:
        """`lin` (no bias) on `x`; under the value cut its whole weight
        is gathered with the reduce-scatter backward (each rank's
        gradient is its value columns' part of a sum over the axis), and
        with `values` this rank's value columns of it are taken."""
        if self.cut != "value":
            return lin(x, reduce)
        w, _ = lin.whole(alike=False)
        if values:
            w = self._values(w, 1)
        return torch.matmul(x, w.to(x.dtype))

    def _proj_heads(self, xr, xk, xv, xg, reduce: bool = True):
        b, s, _ = xr.shape
        h, p, q = self.n_heads, self.head_dim, self.value_dim
        r = self._proj(self.r, xr, reduce).reshape(b, s, h, p)
        k = self._proj(self.k, xk, reduce).reshape(b, s, h, p)
        v = self._proj(self.v, xv, reduce, values=True).reshape(b, s, h, q)
        g = F.silu(self._proj(self.g, xg, reduce, values=True))
        return r, k, v, g

    def _out(self, wkv_out: torch.Tensor, g: torch.Tensor, b: int, s: int,
             reduce: bool = True):
        y = self.ln_x(wkv_out.reshape(b, s, self.n_heads * self.value_dim))
        y = (y * g).to(g.dtype)
        if self.cut != "value":
            return self.o(y, reduce)
        w, _ = self.o.whole(alike=False)
        y = torch.matmul(y, self._values(w, 0).to(y.dtype))
        return reduce_from(y, self.axis) if reduce else y

    def forward(self, x: torch.Tensor, shift_prev: torch.Tensor,
                wkv_prev: torch.Tensor, reduce: bool = True):
        """Chunked form.  x [B, S, d] -> (out, last token, wkv state).
        With ``reduce=False`` (inside a sequence-parallel region: `x` the
        whole gathered sequence, so the token shift and the recurrence
        see every earlier position) a split layer reads `x` as it is and
        gives this rank's part of ``o``'s sum over the axis."""
        b, s, _ = x.shape
        h, p, q = self.n_heads, self.head_dim, self.value_dim
        f32 = torch.promote_types(x.dtype, torch.float32)
        if reduce:
            x = copy_to(x, self.axis)
        x_prev = torch.cat([shift_prev[:, None].to(x.dtype), x[:, :-1]],
                           dim=1)
        xr, xk, xv, xg, xw = self._mix(x, x_prev)
        r, k, v, g = self._proj_heads(xr, xk, xv, xg, reduce)
        logw = self._decay(xw).reshape(b, s, h, p)  # [B, S, H, dk]
        u = self._mine(self.bonus_u, 0).to(f32)  # [H, dk]

        l = chunk_length(self.chunk, s)
        nc = s // l
        rf = r.reshape(b, nc, l, h, p).to(f32)
        kf = k.reshape(b, nc, l, h, p).to(f32)
        vf = v.reshape(b, nc, l, h, q).to(f32)
        wf = logw.reshape(b, nc, l, h, p)
        strict = torch.ones((l, l), dtype=torch.bool,
                            device=x.device).tril(-1)[None, None]
        zero = torch.zeros((), dtype=f32, device=x.device)

        state = wkv_prev.to(f32)   # [B, H, dk, q]
        ys = []
        for c in range(nc):
            rk, kk, vk, wk = rf[:, c], kf[:, c], vf[:, c], wf[:, c]
            lcum = torch.cumsum(wk, dim=1)  # inclusive log decay
            lexc = lcum - wk                # exclusive
            r_t = rk * torch.exp(lexc)
            k_s = kk * torch.exp(-lcum)
            att = torch.einsum("bthd,bshd->bhts", r_t, k_s)
            att = torch.where(strict, att, zero)
            y = torch.einsum("bhts,bshd->bthd", att, vk)
            # the current token's bonus term
            y = y + torch.einsum("bthd,hd,bthd->bth", rk, u,
                                 kk)[..., None] * vk
            # inter-chunk
            y = y + torch.einsum("bthd,bhde->bthe", r_t, state)
            dec_end = torch.exp(lcum[:, -1:] - lcum)  # [B, l, H, p]
            state = (state * torch.exp(lcum[:, -1])[..., None]
                     + torch.einsum("bshd,bshe->bhde", kk * dec_end, vk))
            ys.append(y)
        y = torch.stack(ys, dim=1).reshape(b, s, h, q).to(x.dtype)
        out = self._out(y, g, b, s, reduce)
        return out, x[:, -1].to(shift_prev.dtype), state

    def decode_step(self, x: torch.Tensor, shift_prev: torch.Tensor,
                    wkv_prev: torch.Tensor):
        """x [B, 1, d]; the state [B, H, dk, q] (this rank's value
        columns under the value cut)."""
        b = x.shape[0]
        h, p = self.n_heads, self.head_dim
        f32 = torch.promote_types(x.dtype, torch.float32)
        x = copy_to(x, self.axis)
        x_prev = shift_prev[:, None].to(x.dtype)
        xr, xk, xv, xg, xw = self._mix(x, x_prev)
        r, k, v, g = self._proj_heads(xr, xk, xv, xg)
        logw = self._decay(xw).reshape(b, h, p)
        u = self._mine(self.bonus_u, 0).to(f32)
        r1 = r[:, 0].to(f32)
        k1 = k[:, 0].to(f32)
        v1 = v[:, 0].to(f32)
        kv = torch.einsum("bhd,bhe->bhde", k1, v1)
        y = torch.einsum("bhd,bhde->bhe", r1,
                         wkv_prev + u[None, :, :, None] * kv)
        wkv_new = wkv_prev * torch.exp(logw)[..., None] + kv
        out = self._out(y[:, None], g, b, 1)
        return out, x[:, -1].to(shift_prev.dtype), wkv_new


class RWKV6ChannelMix(nn.Module):
    def __init__(self, d_model: int, hidden: int):
        super().__init__()
        self.d = d_model
        self.hidden = hidden
        self.mu_k = nn.Parameter(torch.zeros(d_model))
        self.mu_r = nn.Parameter(torch.zeros(d_model))
        self.k = Linear(d_model, hidden, use_bias=False,
                        kernel_axes=("embed", "mlp"))
        self.v = Linear(hidden, d_model, use_bias=False,
                        kernel_axes=("mlp", "embed"))
        self.r = Linear(d_model, d_model, use_bias=False,
                        kernel_axes=("embed", "mlp"))
        self.axis: Axis | None = None

    def logical_axes(self) -> dict:
        return {"mu_k": ("embed",), "mu_r": ("embed",)}

    def split_(self, axis: Axis) -> bool:
        """Split the hidden width and r's outputs over the axis (module
        docstring); False (whole) where the axis does not divide both."""
        if not (splits(self.hidden, axis) and splits(self.d, axis)):
            return False
        self.k.split_("column", axis)
        self.v.split_("row", axis)
        self.r.split_("column", axis)
        self.axis = axis
        return True

    def read_in_part(self) -> tuple:
        """The whole leaves a split layer reads for its part alone."""
        return () if self.axis is None else ("mu_k", "mu_r")

    def reset_parameters(self, generator: torch.Generator) -> None:
        """mu_k and mu_r 0.5 (`repro/nn/ssm.py:371-377`)."""
        del generator
        with torch.no_grad():
            self.mu_k.fill_(0.5)
            self.mu_r.fill_(0.5)

    def forward(self, x: torch.Tensor, shift_prev: torch.Tensor,
                reduce: bool = True):
        """x [B, S, d] -> (out, last token).  With ``reduce=False``
        (inside a sequence-parallel region: `x` the whole gathered
        sequence) a split layer reads `x` as it is, and its output, whole
        on every rank, takes the gradient of each rank's part: its
        channels' gather reduce-scatters the gradient back (each rank
        keeps only its slice of the sequence of the output)."""
        if reduce:
            x = copy_to(x, self.axis)
        x_prev = torch.cat([shift_prev[:, None].to(x.dtype), x[:, :-1]],
                           dim=1)
        xx = x_prev - x
        xk = x + xx * self.mu_k.to(x.dtype)
        xr = x + xx * self.mu_r.to(x.dtype)
        kk = torch.square(torch.relu(self.k(xk)))
        if self.axis is None:
            out = torch.sigmoid(self.r(xr)) * self.v(kk)
        else:  # this rank's channels of v's sum, then all of them
            mine = reduce_scatter_seq(self.v(kk, reduce=False), self.axis,
                                      -1)
            out = gather_at_use(torch.sigmoid(self.r(xr)) * mine,
                                self.axis, -1, alike=reduce)
        return out, x[:, -1].to(shift_prev.dtype)
