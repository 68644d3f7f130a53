"""The int8 guide's distance from the f32 guide on a frame's guided rows,
in JAX and in the port, on the same trained checkpoint and rows.

``chip_smoke.py`` (phase ``fb_guide_dtypes``) writes the rows it compares
on the card to ``build/fb_train/guided_rows.npz``: every guided row the
card's int8 guide moves by 0.1 or more from the f32 guide, a seeded sample
of the others, the card's f32, bf16 and int8 actions on them and the
agent's light prototype.  This script runs, on the CPU, JAX's
``as_guide_fn(None)`` and ``as_guide_fn("int8")``
(``raytracer_tpu/fb/quantize.py::make_int8_guide``) and the port's two
guides on those rows with that prototype, and prints one JSON object:

* for JAX, the port on the CPU and the card: the int8 guide's largest and
  mean |difference| from its own f32 guide, over all rows, the far rows
  and the sample, and the rows at or over JAX's 0.15 bound
  (tests/test_quantize.py:38-50);
* the port's int8 guide against JAX's, layer by layer: each of the 17
  products' int8 activations (JAX's recorded inside its jitted guide,
  whose output stays bit for bit the plain one's), the rows where they
  first differ, by how many levels and activations, and how far JAX's
  ``x / scale`` lay from a half level there; the rows' largest output
  difference with and without such a difference.

    python tests/int8_rows_vs_jax.py build/fb_train/guided_rows.npz \\
        build/fb_train/fb_multi_scene_final.npz
"""
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.fb import quantize as jax_quantize  # noqa: E402
from raytracer_tpu.fb.config import FBConfig as JaxConfig  # noqa: E402
from raytracer_tpu.fb.inference import TrainedFBAgent as JaxAgent  # noqa
from raytracer_tpu.fb.inference import small_light_indices as jax_small  # noqa
from raytracer_tpu.scene import library as jax_library  # noqa: E402
from raytracer_tpu_torch.fb.config import FBConfig  # noqa: E402
from raytracer_tpu_torch.fb.inference import TrainedFBAgent  # noqa: E402
from raytracer_tpu_torch.fb.inference import small_light_indices  # noqa

from test_torch_scene import port_scene  # noqa: E402

# ChandelierOnlyTrainer's config (raytracer_tpu_torch/fb/trainer.py).
WIDTHS = dict(max_bounces=8, f_hidden_dim=512, b_hidden_dim=256)
BOUND = 0.15


def summary(int8, f32, far):
    d = np.abs(np.asarray(int8, np.float64) - np.asarray(f32, np.float64))
    row = d.max(1)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "far_rows_max": float(row[far].max()) if far.any() else 0.0,
            "sample_mean": float(d[~far].mean()),
            "rows_at_or_over_bound": int((row >= BOUND).sum())}


def jax_int8_levels(agent, rows):
    """JAX's int8 guide on ``rows`` with each ``_qdense``'s int8
    activations and input recorded: ``(out, [qx], [x])``."""
    qparams = jax_quantize.quantize_agent_params(agent.params,
                                                 agent.light_prototype)
    apply = jax_quantize.Int8AgentApply(z_dim=agent.config.z_dim)
    real, seen = jax_quantize._qdense, []

    def recording(p, x):
        sx = jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0
        sx = jnp.where(sx > 0, sx, 1.0)
        seen.append((jnp.clip(jnp.round(x / sx), -127, 127)
                     .astype(jnp.int8), x))
        return real(p, x)

    @jax.jit
    def forward(qp, obs):
        seen.clear()
        out = apply(qp, obs)
        return out, [s[0] for s in seen], [s[1] for s in seen]

    jax_quantize._qdense = recording
    try:
        out, qx, x = forward(qparams, rows)
    finally:
        jax_quantize._qdense = real
    return (np.asarray(out), [np.asarray(q, np.int32) for q in qx],
            [np.asarray(v, np.float64) for v in x])


def port_int8_levels(guide, rows):
    """The port's int8 guide on ``rows`` with each layer's int8
    activations recorded: ``(out, [qx])``."""
    seen = []
    for layer in guide.layers():
        def taped(qx, real=layer.int_product):
            seen.append(qx.numpy().astype(np.int32))
            return real(qx)
        layer.int_product = taped
    try:
        out = guide(torch.from_numpy(rows)).numpy()
    finally:
        for layer in guide.layers():
            del layer.int_product
    return out, seen


def first_levels_apart(port_q, jax_q, jax_x):
    """Where the two guides' int8 activations first differ, row by row."""
    first = np.full(port_q[0].shape[0], -1)
    levels = acts = 0
    half = 0.0
    for i, (a, b, x) in enumerate(zip(port_q, jax_q, jax_x)):
        new = (a != b).any(1) & (first < 0)
        if not new.any():
            continue
        first[new] = i
        apart = np.abs(a[new] - b[new])
        levels = max(levels, int(apart.max()))
        acts = max(acts, int((apart > 0).sum(1).max()))
        t = np.abs(x[new] / np.maximum(np.abs(x[new]).max(1, keepdims=True)
                                       / 127.0, 1e-30))
        half = max(half, float(np.abs(t - np.floor(t) - 0.5)[apart > 0]
                               .max()))
    return first, {"rows_levels_apart": int((first >= 0).sum()),
                   "rows_first_apart_by_layer": np.bincount(
                       first[first >= 0], minlength=len(port_q)).tolist(),
                   "levels_apart_at_first": levels,
                   "activations_apart_at_first": acts,
                   "jax_distance_from_half_level_at_first": half}


def main(rows_path, ckpt_path):
    data = np.load(rows_path)
    rows, proto = data["rows"], data["proto"]
    far = np.abs(data["int8"] - data["f32"]).max(1) >= 0.1
    js, _, _, p = jax_library.chandelier_scene()
    ja = JaxAgent(str(ckpt_path), js, jax_small(js), p["camera_position"],
                  config=JaxConfig(**WIDTHS))
    ja.light_prototype = proto
    ts = port_scene(js)
    ta = TrainedFBAgent(str(ckpt_path), ts, small_light_indices(ts),
                        p["camera_position"], config=FBConfig(**WIDTHS),
                        device="cpu")
    ta.light_prototype, ta.prototype = proto, torch.from_numpy(proto)
    out = {"rows": int(rows.shape[0]), "far_rows": int(far.sum()),
           "bound": BOUND}
    jf32 = np.asarray(ja.as_guide_fn(None)(rows))
    ji8 = np.asarray(ja.as_guide_fn("int8")(rows))
    ji8_rec, jax_q, jax_x = jax_int8_levels(ja, rows)
    out["jax_recorded_vs_plain_max"] = float(np.abs(ji8_rec - ji8).max())
    out["jax"] = summary(ji8, jf32, far)
    tf32 = ta.as_guide_fn()(torch.from_numpy(rows)).numpy()
    ti8, port_q = port_int8_levels(ta.as_guide_fn("int8"), rows)
    out["port_cpu"] = summary(ti8, tf32, far)
    out["card"] = summary(data["int8"], data["f32"], far)
    out["f32_card_vs_jax_max"] = float(np.abs(data["f32"] - jf32).max())
    out["f32_port_cpu_vs_jax_max"] = float(np.abs(tf32 - jf32).max())
    first, apart = first_levels_apart(port_q, jax_q, jax_x)
    row = np.abs(ti8 - ji8).max(1)
    out["int8_port_cpu_vs_jax"] = dict(
        apart, max_same_levels=float(row[first < 0].max()),
        max_levels_apart=float(row.max()),
        rows_over_1e_5=int((row > 1e-5).sum()))
    print(json.dumps(out))


if __name__ == "__main__":
    main(*sys.argv[1:3])
