"""Roofline of the dry run's cells on the H100 (counterpart of
`repro.launch.roofline`).

Terms per (arch x shape x mesh), seconds a step on each card:

    compute    = FLOPs      / (chips x 989e12 FLOP/s)
    memory     = HBM bytes  / (chips x 3.35e12 B/s)
    collective = sum over mesh axes of (a rank's traced bytes on the
                 axis / the axis line's bandwidth)

Constants, one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet,
dense rates without sparsity): 989e12 bf16 FLOP/s on the tensor cores;
3.35e12 B/s of HBM3.  A collective line whose ranks all sit in one
8-GPU node (the same ``rank // 8``) runs over NVLink 4, 900 GB/s a GPU
in both directions, so 450e9 B/s one way; a line that crosses nodes runs
over the GPU's one NDR InfiniBand NIC, 400 Gb/s = 50e9 B/s.  A 16-wide
axis of consecutive ranks ("model") spans two nodes, and "data" and
"pod" lines stride across nodes, so every axis of the production meshes
crosses.

FLOPs and HBM bytes are the reference's analytic formulas
(`step_flops`, `step_hbm_bytes`), line for line; the microbatch depth
of the bytes is the port's (`repro_torch.launch.specs.auto_microbatches`,
or the dry-run row's).  The collective term needs no rescale, and the
reference's `collective_seconds` and `cost_analysis_dict` have no
counterpart: XLA's text counts a scanned layer's collectives once, so
the reference multiplies them by layers x microbatches, while the
port's layers and microbatches are Python loops and the dry run counts
every `torch.distributed` call of the step (`repro_torch.launch.dryrun`).
Each call's bytes are its result's, as the reference counts HLO result
shapes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.registry import get_config

PEAK_FLOPS = 989e12          # bf16 FLOP/s a card
HBM_BW = 3.35e12             # B/s a card
NVLINK_BW = 450e9            # B/s one direction, a line inside one node
NIC_BW = 50e9                # B/s, one 400 Gb/s NIC, a line across nodes
NODE_GPUS = 8
DEFAULT_DRYRUN = "results/dryrun_torch.json"
DEFAULT_OUT = "results/roofline_torch.json"


# ---------------------------------------------------------------------------
# Analytic FLOPs / bytes per step (whole job, later divided by chips)
# ---------------------------------------------------------------------------

def _attention_flops(cfg: ArchConfig, tokens: int, kv_len: int,
                     causal_half: bool) -> float:
    """QK^T + PV for all layers; causal_half halves the quadratic term."""
    hd = cfg.resolved_head_dim
    layers = cfg.num_layers if cfg.family != "audio" else 0
    quad = 2 * 2 * tokens * kv_len * cfg.n_heads * hd
    if causal_half:
        quad /= 2
    return layers * quad


def step_flops(cfg: ArchConfig, shape: ShapeConfig, *,
               causal_skip: bool = False) -> dict:
    """model_flops (6ND ideal) and compiled_flops (with the attention's
    quadratic term and the remat recompute factor)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        # fwd + 2x bwd (+ full fwd recompute under remat="layer";
        # "dots" saves matmul outputs -> ~0.3 pass of recompute)
        passes = {"layer": 4, "dots": 3.3, "none": 3}.get(cfg.remat, 4)
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        passes = 1
    else:  # decode: one token per sequence
        tokens = shape.global_batch * 1
        passes = 1

    n_active = cfg.active_param_count_estimate()
    model = 2 * n_active * tokens * (3 if shape.kind == "train" else 1)

    flops = 2 * n_active * tokens * passes
    # attention quadratic term (not in 6ND)
    if cfg.family in ("dense", "moe", "vlm"):
        kv_len = shape.seq_len
        att = _attention_flops(cfg, tokens, kv_len,
                               causal_half=causal_skip or
                               shape.kind == "decode")
        flops += att * (passes if shape.kind == "train" else 1)
    elif cfg.family == "audio":
        enc_tokens = shape.global_batch * shape.seq_len
        hd = cfg.resolved_head_dim
        enc_att = 2 * 2 * enc_tokens * shape.seq_len * cfg.n_heads * hd \
            * cfg.enc_layers
        flops += enc_att * (passes if shape.kind == "train" else 1)
    elif cfg.family == "hybrid":
        # mamba scan ~ linear; shared attention blocks quadratic
        g = max(1, cfg.num_layers // cfg.hybrid_attn_every)
        hd = cfg.resolved_head_dim
        kv_len = shape.seq_len
        att = 2 * 2 * tokens * kv_len * cfg.n_heads * hd * g
        if causal_skip or shape.kind == "decode":
            att /= 2
        flops += att * (passes if shape.kind == "train" else 1)
    # ssm (rwkv6): chunked linear attention is O(T·chunk·d); add the
    # state-expansion term
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.ssm_head_dim
        p = cfg.ssm_head_dim
        flops += 2 * tokens * h * p * p * cfg.num_layers \
            * (passes if shape.kind == "train" else 1)
    return {"model_flops": float(model), "compiled_flops": float(flops)}


def step_hbm_bytes(cfg: ArchConfig, shape: ShapeConfig, chips: int,
                   n_microbatches: int | None = None) -> float:
    """Dominant HBM traffic per step across the whole job.

    Weights: streamed once per (micro)batch pass (train: weight bytes x
    passes x microbatches).  KV cache: decode reads the whole cache once
    a step.  Activations: ~2 bytes x tokens x d x layers x passes (block
    I/O).  The depth is `n_microbatches`, or the port's
    `auto_microbatches` for the cell."""
    del chips
    pdt_bytes = 2 if cfg.param_dtype == "bfloat16" else 4
    weights = cfg.param_count_estimate() * pdt_bytes
    act_tokens = (shape.global_batch * shape.seq_len
                  if shape.kind != "decode" else shape.global_batch)
    layers = cfg.num_layers + (cfg.dec_layers if cfg.family == "audio"
                               else 0)
    acts = 2 * act_tokens * cfg.d_model * layers * 4  # r/w both ends
    if shape.kind == "train":
        if n_microbatches is None:
            from repro_torch.launch.specs import auto_microbatches
            n_microbatches = auto_microbatches(cfg, shape)
        passes = 3
        total = weights * passes * n_microbatches + acts * passes
        # optimizer state read+write once
        total += 2 * weights
    elif shape.kind == "prefill":
        total = weights + acts
    else:
        kvb = 1 if cfg.kv_cache_dtype.startswith("float8") else 2
        if cfg.family == "ssm":
            h = cfg.d_model // cfg.ssm_head_dim
            kv = (cfg.num_layers * shape.global_batch
                  * h * cfg.ssm_head_dim ** 2 * 4)
        elif cfg.family == "hybrid":
            g = max(1, cfg.num_layers // cfg.hybrid_attn_every)
            kv = (g * 2 * shape.global_batch * shape.seq_len
                  * cfg.n_kv_heads * cfg.resolved_head_dim * kvb)
            kv += (cfg.num_layers * shape.global_batch
                   * (2 * cfg.d_model // cfg.ssm_head_dim)
                   * cfg.ssm_head_dim * cfg.ssm_state * 4)
        else:
            layers_kv = (cfg.dec_layers if cfg.family == "audio"
                         else cfg.num_layers)
            kv_len = shape.seq_len
            kv = (layers_kv * 2 * shape.global_batch * kv_len
                  * cfg.n_kv_heads * cfg.resolved_head_dim * kvb)
        total = weights + kv + acts
    return float(total)


def line_bandwidth(ranks) -> float:
    """B/s of one collective line: NVLink inside one 8-GPU node, the NIC
    across nodes."""
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) <= 1 \
        else NIC_BW


def collective_seconds(dryrun_row: dict) -> dict:
    """{axis: seconds} of a rank's traced collective bytes on each mesh
    axis over its line's bandwidth."""
    lines = dryrun_row.get("axis_ranks", {})
    return {axis: v["bytes"] / line_bandwidth(lines.get(axis, (0, NODE_GPUS)))
            for axis, v in dryrun_row["collectives"]["per_axis"].items()}


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    compiled_flops: float
    useful_fraction: float
    mfu: float

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(dryrun_row: dict, *, causal_skip: bool | None = None,
            shape: ShapeConfig | None = None) -> RooflineRow:
    """The row's three terms, its bound and MFU; `shape` stands in for
    a shape that `SHAPES` does not name (a run outside the cells)."""
    cfg = get_config(dryrun_row["arch"])
    shape = shape or SHAPES[dryrun_row["shape"]]
    chips = dryrun_row["n_chips"]
    if causal_skip is None:
        causal_skip = cfg.skip_masked_chunks
    fl = step_flops(cfg, shape, causal_skip=causal_skip)
    compute_s = fl["compiled_flops"] / (chips * PEAK_FLOPS)
    memory_s = step_hbm_bytes(
        cfg, shape, chips, dryrun_row.get("n_microbatches")
    ) / (chips * HBM_BW)
    coll_s = sum(collective_seconds(dryrun_row).values())
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values())
    mfu = (fl["model_flops"] / (chips * PEAK_FLOPS)) / max(step_time, 1e-12)
    return RooflineRow(
        arch=dryrun_row["arch"], shape=dryrun_row["shape"],
        mesh=dryrun_row["mesh"], chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=bottleneck,
        model_flops=fl["model_flops"],
        compiled_flops=fl["compiled_flops"],
        useful_fraction=fl["model_flops"] / max(fl["compiled_flops"], 1.0),
        mfu=mfu)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default=DEFAULT_DRYRUN)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--mesh", default="16x16",
                    help="roofline table mesh (single-pod per spec)")
    args = ap.parse_args(argv)
    rows = json.loads(Path(args.dryrun).read_text())
    out = []
    print(f"{'arch':22s} {'shape':12s} {'comp_s':>9s} {'mem_s':>9s} "
          f"{'coll_s':>9s} {'bound':>10s} {'MFU%':>6s} {'useful%':>8s}")
    for r in rows:
        if r.get("status") != "OK" or r["mesh"] != args.mesh:
            continue
        a = analyze(r)
        out.append(a.as_dict())
        print(f"{a.arch:22s} {a.shape:12s} {a.compute_s:9.4f} "
              f"{a.memory_s:9.4f} {a.collective_s:9.4f} "
              f"{a.bottleneck:>10s} {100*a.mfu:6.1f} "
              f"{100*a.useful_fraction:8.1f}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
