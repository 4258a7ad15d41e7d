"""Analytic interconnect traffic / scaling-efficiency model, and the
picks made from it: the port's copy of
``stereomatch_tpu/parallel/ici_model.py`` (same functions, keywords and
arithmetic).

"ICI" here means the link between the mesh's tile devices: what the
carry hand-off and the halo rows cross.  Its rates default to the H100's
own, measured by ``chip_smoke.py`` (``check_distributed``): the
[3, W, D] float32 carry copied from one tile device to the next
(``CARRY_GBPS``), the time one exact hand-off stage adds (``STAGE_US``:
a chunk-kernel launch on one row from its predecessor's carry, with the
carry's copy) and the card's own copy rate (``COPY_GBPS``: the bytes a
device-to-device copy reads and writes, over its time).  None of the
JAX module's TPU figures is kept.

Efficiency is predicted, not measured: the bytes each configuration
moves between tile devices per frame (halos, carries, reduction
combines), against the per-device bytes of the compute itself, as
hbm_time / (hbm_time + ici_time + serialization).
"""

from __future__ import annotations

# NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's check_distributed
# (PERF.md section 6, the run that set these rates).  Two tile devices
# on one card, so the carry's copy is a copy within the card, one
# enqueue a copy: the lower of teddy's (375x450, D=128: 79.40 GB/s, 8.71
# us a copy) and HD's (1024x1280, D=256: 463.45 GB/s, 8.48 us) rates.
CARRY_GBPS = 79.40
# The same run: the larger of teddy's (55.96 us) and HD's (65.10 us)
# stage times.
STAGE_US = 65.10
# The same run: a 1 GiB copy within the card, 2 GiB read and written in
# 0.7245 ms.
COPY_GBPS = 2963.91


def ici_traffic_model(*, height, width, disp, tiles, kernel=7, overlap=48,
                      cvf_radius=8, itemsize=4, ici_gbps=CARRY_GBPS,
                      hbm_gbps=COPY_GBPS, hop_latency_us=STAGE_US, batch=1):
    """Per-config traffic between tile devices and predicted scaling
    efficiency.

    ``batch`` is the local frames per device: the exact SGM hand-off
    runs as a (frame, tile) wavefront, so its serialization cost
    amortizes as (tiles + batch - 1) / batch stages per frame instead of
    ``tiles``.  Returns a list of per-config dicts.
    """
    T = tiles
    B = max(batch, 1)
    vol = height * width * disp * itemsize          # one full volume
    hl = height // T
    rows = []

    def add(name, ici_bytes, serial_stages, compute_scale=1.0, note=""):
        # Per-device compute: the full pipeline moves ~16 volume-sized
        # memory transfers (cost ~5, SGM ~10, WTA ~1); each device owns
        # 1/T of it.
        hbm_bytes = 16 * vol * compute_scale / T
        hbm_ms = hbm_bytes / 1e9 / hbm_gbps * 1e3
        ici_ms = (ici_bytes / 1e9 / ici_gbps * 1e3
                  + serial_stages * hop_latency_us / 1e3)
        rows.append({
            "config": name, "tiles": T,
            "ici_bytes_per_frame": int(ici_bytes),
            "ici_vs_volume": round(ici_bytes / vol, 4),
            "serial_stages": serial_stages,
            "hbm_bytes_per_chip": int(hbm_bytes),
            "ici_ms": round(ici_ms, 4), "hbm_ms": round(hbm_ms, 4),
            "predicted_efficiency": round(hbm_ms / (hbm_ms + ici_ms), 3),
            "note": note,
        })

    b = T - 1                                        # tile boundaries
    img_halo = 2 * 2 * kernel * width * 4 * b        # 2 images x 2 dirs

    # Row-sharded SGM, exact carry hand-off (sharded.py): a 3-family
    # [3, W, D] carry per boundary, forward + reverse, float32 whatever
    # the storage dtype.  The hand-off serializes 2 * (T + B - 1)
    # wavefront stages over B frames: per frame, the serialization
    # amortizes with the batch.
    add("sgm_exact",
        img_halo + 2 * b * 3 * width * disp * 4,
        serial_stages=max(1, round(2 * (T + B - 1) / B)),
        note=f"carry [3,W,D] fwd+rev per boundary; (frame,tile) "
             f"wavefront over batch={B}")

    # Row-sharded SGM, overlap mode: image halos of (overlap + kernel)
    # rows, no carries, no serialization; each tile computes 2*overlap
    # redundant rows.
    add("sgm_overlap",
        2 * 2 * (overlap + kernel) * width * 4 * b,
        serial_stages=1,
        compute_scale=(hl + 2 * overlap) / hl,
        note=f"redundant compute x{(hl + 2 * overlap) / hl:.2f}")

    # 2-D tiling (tiled2d.py): row halos + column halos; the LR volume
    # re-index ships a D-column volume slab along the W axis.
    tw = max(int(T ** 0.5), 1)
    th = max(T // tw, 1)
    add("tiled2d_lr_volume",
        2 * 2 * (overlap + kernel) * width * 4 * (th - 1)
        + 2 * 2 * (overlap + kernel) * (height // th) * 4 * (tw - 1)
        + (disp * (height // th) * disp * itemsize) * (tw - 1),
        serial_stages=2,
        note="row+col halos + D-column LR volume slab per W boundary")

    # Disparity-block WTA (disp_sharded.py): per-pixel (min, argmin)
    # combine over the D blocks.
    add("disp_sharded_wta",
        2 * b / max(T, 1) * height * width * 8 * T,
        serial_stages=1,
        note="per-pixel (val,idx) all-reduce")

    # CVF row-sharded (sharded.py): 2*radius volume+guide halo rows per
    # boundary, both directions.
    add("cvf",
        2 * 2 * cvf_radius * width * (disp * itemsize + 4) * b,
        serial_stages=1,
        note="volume+guide halos of 2r rows")

    # FGS (sharded.py): the Thomas hand-off across tiles: per iteration,
    # forward c'/d' rows and backward u0 row per boundary, 3 iterations
    # x row+column solves.
    add("fgs",
        3 * 2 * (2 + 1) * width * 4 * b,
        serial_stages=3 * 2 * T,
        note="tridiagonal c',d' fwd + u0 bwd per boundary, 3 iters")

    # Temporal band tracking (temporal_sharded.py): census-code halo rows
    # for the band window + the poor-fraction sums (a scalar pair).
    add("temporal_band",
        2 * 2 * ((5 // 2) + 1) * width * 4 * b + 8 * T,
        serial_stages=1,
        note="code halos + scalar psum")

    return rows


def select_exact_schedule(*, tiles, batch, vmap_eff=0.585):
    """Wavefront vs naive hand-off schedule for EXACT row-sharded SGM.

    Cost model (chunk units): naive = tiles * batch * vmap_eff,
    wavefront = tiles + batch - 1; at batch 1 the two are the same
    computation and naive is returned.  ``vmap_eff`` = 0.585 is the JAX
    package's fit on its CPU mesh, kept as it is: in the port all three
    ``sgm_schedule`` values make the same launches in the same order
    (``sharded.py``), so nothing here measures it.
    """
    T, B = max(tiles, 1), max(batch, 1)
    naive_cost = T * B * vmap_eff
    wave_cost = T + B - 1
    schedule = "wavefront" if wave_cost < naive_cost and B > 1 else "naive"
    return schedule, {
        "naive_chunk_units": round(naive_cost, 2),
        "wavefront_chunk_units": wave_cost,
        "tiles": T, "batch": B, "picked": schedule,
    }


def select_sgm_mode(*, height, width, disp, tiles, batch=1, overlap=64,
                    ici_gbps=CARRY_GBPS, hbm_gbps=COPY_GBPS,
                    hop_latency_us=STAGE_US):
    """Pick the row-sharded SGM strategy from the model's predictions.

    Returns (mode, info): mode is "exact" or "overlap"; info carries both
    configs' predicted efficiencies.  EXACT is preferred whenever its
    predicted efficiency is within 5% of overlap's (it is bit-exact
    against the single device, overlap a warm-up approximation), so
    overlap is picked only when the model says the serial chain
    dominates (few frames per device, many tiles).  ``hop_latency_us``
    is the port's addition (JAX's always takes its model's default).
    """
    rows = {r["config"]: r for r in ici_traffic_model(
        height=height, width=width, disp=disp, tiles=tiles, batch=batch,
        overlap=overlap, ici_gbps=ici_gbps, hbm_gbps=hbm_gbps,
        hop_latency_us=hop_latency_us)}
    exact = rows["sgm_exact"]
    over = rows["sgm_overlap"]
    mode = ("exact" if exact["predicted_efficiency"]
            >= 0.95 * over["predicted_efficiency"] else "overlap")
    return mode, {
        "exact_efficiency": exact["predicted_efficiency"],
        "overlap_efficiency": over["predicted_efficiency"],
        "batch": batch, "tiles": tiles,
        "picked": mode,
    }
