"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
full 700 W power limit), and the least times the rooflines divide by.

float32 outside the tensor cores is 67 TFLOP/s with a fused multiply-add
counted as two: every f32 add or multiply the work needs counts one
against it, whether or not the build fuses them."""
from __future__ import annotations

from .reference import work as W

F32 = 67e12
BF16 = 989e12
HBM_BYTES = 3.35e12


def guide_flops(run) -> float:
    """The guide's flops a frame on the rows it steered."""
    g = run.config["guide"]
    if not run.mix["guided"]:
        return 0.0
    rows = run.work["guided_rows"]
    if g["kind"] == "student":
        return rows * W.student_row_flops(g["widths"])
    return rows * W.agent_row_flops(g["z_dim"], g["e_hidden_dim"],
                                    g["b_hidden_dim"])


def guide_s(run) -> float:
    peak = BF16 if run.config["guide"]["kind"] == "student" else F32
    return guide_flops(run) / peak


def path_kernel_s(run) -> float:
    """The whole-trace path kernel's least time a frame: its operations
    (the levels, the first normalisation) and the student's flops, or its
    bytes (rays in, rgb and counts out, the draws its diffuse lanes
    read)."""
    w, mix = run.work, run.mix
    ops = W.level_ops(w) + W.OPS_PER_RAY * w["rays"]
    t = ops / F32 + guide_s(run)
    counts = 6 if mix["guided"] else 4
    nbytes = w["rays"] * (W.RAY_IN + W.RGB_OUT + W.COUNT * counts)
    if mix["guided"]:
        nbytes += (W.FB_UNIFORM * w["diffuse"]
                   + W.UNIFORMS * (w["diffuse"] - w["guided_rows"]))
    else:
        nbytes += W.UNIFORMS * w["diffuse"]
    return max(t, nbytes / HBM_BYTES)


def level_kernel_s(run) -> float:
    """The level kernel's least time a frame, over its launches: the
    levels' operations, or their bytes (every lane's traffic, the hit
    plane of a guided level, a diffuse lane's draws)."""
    w, mix = run.work, run.mix
    guided_levels = w["levels"] if mix["guided"] else 0
    nbytes = (w["levels"] * w["rays"] * W.LEVEL_LANE
              + guided_levels * w["rays"] * W.LEVEL_HIT
              + W.UNIFORMS * w["diffuse"])
    return max(W.level_ops(w) / F32, nbytes / HBM_BYTES)


def frame_s(run) -> float:
    """The frame's least time: its f32 operations (camera, levels, first
    normalisation, the //spp fold) and its guide's flops, or the bytes of
    its draws and its image."""
    w, mix = run.work, run.mix
    spp = mix["spp"]
    ops = (W.level_ops(w) + (W.OPS_PER_RAY + W.OPS_CAMERA) * w["rays"]
           + 3 * w["pixels"] * (spp - 1 + W.OPS_FOLD_CHANNEL))
    t = ops / F32 + guide_s(run)
    levels = run.config["max_bounces"]
    nbytes = w["rays"] * 2 * 4 + w["pixels"] * 3 * 4
    if run.diffuse:
        nbytes += levels * w["rays"] * (2 * 4 + (4 if mix["guided"] else 0))
    return max(t, nbytes / HBM_BYTES)
