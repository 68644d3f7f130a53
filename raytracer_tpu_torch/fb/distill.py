"""Distilled FB students: the deployment guide ``obs[R, 22] -> action[R, 2]``.

Counterpart of ``raytracer_tpu/fb/distill.py``.  Inference:
``StudentPolicy`` (a ReLU MLP with a raw output), ``DistilledGuide`` with its
flat-npz ``load`` and ``save`` (each package reads the other's), and
``as_guide_fn``.  Training: ``collect_observations`` (the diffuse lanes'
observations of teacher-guided renders, each level the stepwise level of
``core/cuda_path.py``: the nearest-hit kernel on the card), the targets
(``light_hit_weights``, ``hindsight_aim_targets``,
``best_of_teachers_targets``: each action shot from its surface point
through ``core/cuda_intersect.py::nearest_hit``, the kernel on the card),
``distill`` (weighted MSE, ``torch.optim.Adam`` under optax's cosine
decay, the jitter copies and permutations from ``np.random.default_rng``
as JAX draws them), ``distill_agent`` and ``distill_ensemble``.

``as_guide_fn(dtype="auto")`` runs the student in bfloat16 in the order
flax's ``Dense`` chain has under XLA: observations and parameters rounded to
bf16; per layer an f32-accumulated product of the bf16 values, rounded to
bf16, then ``+ bias`` in bf16 (a second rounding), then ReLU.  The output
layer's product is rounded to bf16 too, but its bias add stays in f32: XLA
folds that add's bf16 round trip into the cast to the f32 output (measured
on the CPU, every output equal).  ``dtype=None`` is exact f32 (``x @ W + b``
per layer).  The guide
carries its layers, so the path kernels can run the same student inside
themselves (``core/cuda_path.py``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import cuda_intersect, cuda_path, vec
from ..core.cuda_intersect import sphere_table
from ..core.device import resolve_device
from ..render.camera import perspective_rays
from ..trace.path import emissive_indices, observation_c, scene_spec
from ..trace.sampling import (direction_to_action, fb_action_to_direction,
                              fb_action_to_direction_c)
from .networks import _lecun_normal

OBS_DIM = 22
ACTION_DIM = 2


class StudentPolicy(nn.Module):
    """Linear layers with ReLU between them and a raw output, f32."""

    def __init__(self, hidden: Sequence[int] = (64, 64),
                 obs_dim: int = OBS_DIM, action_dim: int = ACTION_DIM):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        dims = (obs_dim,) + self.hidden + (action_dim,)
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def _flat_params(params: Mapping) -> Dict[str, np.ndarray]:
    """``{"Dense_i/kernel": [in, out], "Dense_i/bias": [out]}`` from the JAX
    package's nested params (``params["Dense_i"]["kernel"]``) or from the
    flat npz keys; other keys (``__hidden__``, ``__obs_dim__``) dropped."""
    flat = {}
    for k, v in params.items():
        if k.startswith("__"):
            continue
        if isinstance(v, Mapping):
            for name in ("kernel", "bias"):
                flat[f"{k}/{name}"] = np.asarray(v[name], np.float32)
        else:
            flat[k] = np.asarray(v, np.float32)
    return flat


def _layer_arrays(params: Mapping) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                            ...]:
    flat = _flat_params(params)
    n = len({k.split("/")[0] for k in flat})
    return tuple((flat[f"Dense_{i}/kernel"], flat[f"Dense_{i}/bias"])
                 for i in range(n))


def state_dict_from_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's student params as a ``StudentPolicy`` state dict.
    flax keeps ``kernel [in, out]``; ``nn.Linear`` keeps ``weight [out,
    in]``, so each kernel is transposed."""
    sd = {}
    for i, (k, b) in enumerate(_layer_arrays(params)):
        sd[f"layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.T))
        sd[f"layers.{i}.bias"] = torch.from_numpy(b.copy())
    return sd


class StudentGuide:
    """A student as a guide: ``guide(obs [R, 22]) -> action [R, 2]`` f32.

    ``layers``: ``((kernel [in, out], bias [out]), ...)`` float32 CPU
    tensors, already rounded to bf16 when ``dtype == "bfloat16"``;
    ``dtype``: ``"bfloat16"`` or None (exact f32)."""

    def __init__(self, layers, dtype: Optional[str]):
        if dtype not in ("bfloat16", None):
            raise ValueError(f"unsupported guide dtype {dtype!r}")
        self.dtype = dtype
        q = ((lambda t: t.bfloat16().float()) if dtype == "bfloat16"
             else (lambda t: t))
        self.layers = tuple((q(torch.as_tensor(k, dtype=torch.float32)),
                             q(torch.as_tensor(b, dtype=torch.float32)))
                            for k, b in layers)
        self.hidden = tuple(k.shape[1] for k, _ in self.layers[:-1])
        self._on: Dict[torch.device, tuple] = {}

    def layers_on(self, device) -> tuple:
        """The layers on ``device`` (copied once per device)."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple((k.to(device), b.to(device))
                                     for k, b in self.layers)
        return self._on[device]

    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.float()
        layers = self.layers_on(x.device)
        bf16 = self.dtype == "bfloat16"
        if bf16:
            x = x.bfloat16()
        last = len(layers) - 1
        for i, (k, b) in enumerate(layers):
            if not bf16:
                x = torch.matmul(x, k) + b
            elif i < last:
                # f32-accumulated product of bf16 values, rounded to bf16;
                # then + bias in bf16 (flax Dense under XLA, in that order).
                x = torch.matmul(x.float(), k).bfloat16() + b.bfloat16()
            else:
                # The output layer: XLA drops the bf16 round trip of the
                # bias add before the f32 cast, so the add stays in f32.
                x = torch.matmul(x.float(), k).bfloat16().float() + b
            if i < last:
                x = torch.relu(x)
        return x.float()


class DistilledGuide:
    """Deployment guide: ``obs[R, 22] -> action[R, 2]`` through the
    student."""

    def __init__(self, params: Mapping, hidden: Sequence[int] = (64, 64)):
        self.hidden = tuple(int(h) for h in hidden)
        self.layers = _layer_arrays(params)
        widths = tuple(k.shape[1] for k, _ in self.layers[:-1])
        if widths != self.hidden:
            raise ValueError(f"params have hidden widths {widths}, "
                             f"not {self.hidden}")

    def module(self) -> StudentPolicy:
        """The student as an f32 ``StudentPolicy``."""
        m = StudentPolicy(self.hidden, self.layers[0][0].shape[0],
                          self.layers[-1][0].shape[1])
        m.load_state_dict(state_dict_from_params(
            {f"Dense_{i}": {"kernel": k, "bias": b}
             for i, (k, b) in enumerate(self.layers)}))
        return m

    def as_guide_fn(self, dtype="auto") -> StudentGuide:
        """``"auto"``: bfloat16 in flax's order (the deployed mode; JAX
        ``as_guide_fn``'s default); None: exact f32."""
        if dtype == "auto" or dtype is torch.bfloat16:
            dtype = "bfloat16"
        return StudentGuide(self.layers, dtype)

    def save(self, path, obs_dim: int = OBS_DIM) -> None:
        """The flat npz JAX's ``DistilledGuide.load`` reads: ``__hidden__``,
        ``__obs_dim__`` and ``Dense_i/bias``, ``Dense_i/kernel``."""
        flat = {}
        for i, (k, b) in enumerate(self.layers):
            flat[f"Dense_{i}/bias"] = np.asarray(b, np.float32)
            flat[f"Dense_{i}/kernel"] = np.asarray(k, np.float32)
        np.savez(path, __hidden__=np.asarray(self.hidden, np.int64),
                 __obs_dim__=np.asarray(obs_dim, np.int64), **flat)

    @staticmethod
    def load(path) -> "DistilledGuide":
        """Read the flat npz the JAX package saves (``__hidden__``,
        ``__obs_dim__``, ``Dense_i/kernel``, ``Dense_i/bias``)."""
        with np.load(path) as z:
            hidden = tuple(int(h) for h in z["__hidden__"])
            flat = {k: z[k] for k in z.files}
        return DistilledGuide(flat, hidden)


# -- training ----------------------------------------------------------------

def _guided_walk_frame(scene, guide_fn, jitter, uniforms, *, width, height,
                       max_bounces, camera_position, mirror_threshold):
    """One frame of ``collect_observations``: each level's diffuse lanes'
    observations, ``[n, 22]`` tensors on the scene's device."""
    dev = scene.device
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 mirror_threshold, dev)
    sweep = sphere_table(scene)
    o, d = perspective_rays(width, height, fov=60.0, origin=camera_position,
                            sample_xy=jitter)
    o = o.contiguous()
    d = torch.stack(vec.normalise_safe_c(*d.unbind(-1)), dim=-1)
    running = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    out = []
    for lvl in range(max_bounces):
        lv = cuda_path.level_stepwise(o, d, running, uniforms[lvl], table,
                                      sweep=sweep, want_hit=True)
        cont = (lv.state & cuda_path.ST_CONT) != 0
        diffuse = cont & ((lv.state & cuda_path.ST_MIRROR) == 0)
        h = lv.hit
        obs = observation_c(h[:, 0], h[:, 1], h[:, 2], d[:, 0], d[:, 1],
                            d[:, 2], *h[:, 3:].unbind(1), lvl, max_bounces)
        act = torch.clamp(guide_fn(obs), -1.0, 1.0)
        g = torch.stack(fb_action_to_direction_c(act[:, 0], act[:, 1],
                                                 h[:, 3], h[:, 4], h[:, 5]),
                        dim=-1)
        d_next = torch.where(diffuse[:, None], g, lv.d_next)
        out.append(obs[diffuse])
        o, d, running = lv.o_next, d_next, cont
    return out


def collect_observations(scene, guide_fn, *, width: int = 128,
                         height: int = 64, spp: int = 4,
                         max_bounces: int = 8, frames: int = 4,
                         camera_position=(0.0, 2.0, 0.0),
                         mirror_threshold: float = 0.9,
                         frame_planes: Optional[Sequence] = None,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> np.ndarray:
    """Observation wavefronts from guided renders: the on-path distribution
    the deployed guide sees (JAX ``collect_observations`` :48).  Each level
    is ``cuda_path.level_stepwise`` (JAX ``_level_kernel(want_obs=True)``);
    the guide steers every diffuse lane (``_apply_guide``) and the diffuse
    lanes' observations are kept, frame by frame and level by level.

    ``frame_planes``: a ``(jitter [spp, H, W, 2], uniforms [L, R, 2])`` pair
    a frame (JAX: ``key, kf, kt = split(key, 3)`` a frame, the jitter
    ``uniform(kf, ...)``, level ``l``'s ``k_diff = split(split(kt, L)[l])
    [0]``); else ``generator`` draws each frame's jitter, then its uniforms.
    The frame's aspect selects the scene regions the paths visit, so
    ``distill_agent`` collects at 2:1 and at 4:3.  Returns ``[n, 22]``
    float32."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    R = spp * height * width
    out = []
    for f in range(frames):
        if frame_planes is not None:
            jitter, u = (torch.as_tensor(p).to(dev, torch.float32)
                         for p in frame_planes[f])
        else:
            if generator is None:
                raise ValueError("pass frame_planes or a generator")
            jitter = torch.rand((spp, height, width, 2), generator=generator,
                                device=dev)
            u = torch.rand((max_bounces, R, 2), generator=generator,
                           device=dev)
        out += _guided_walk_frame(scene, guide_fn, jitter, u, width=width,
                                  height=height, max_bounces=max_bounces,
                                  camera_position=camera_position,
                                  mirror_threshold=mirror_threshold)
    rows = [o.cpu().numpy() for o in out if o.shape[0]]
    return (np.concatenate(rows) if rows
            else np.zeros((0, OBS_DIM), np.float32))


@dataclasses.dataclass
class DistillResult:
    """The student's parameters (JAX's layout), widths, last loss and
    observation count (jitter copies included), with the Adam steps taken
    and the host seconds of each stage (``collect`` from
    ``distill_agent``/``distill_ensemble``, ``targets`` and ``train``)."""
    params: dict
    hidden: Tuple[int, ...]
    final_loss: float
    n_obs: int
    steps: int = 0
    seconds: dict = dataclasses.field(default_factory=dict)


def _chunked(fn, arr, device, chunk=1 << 19):
    """``fn`` over row chunks on ``device`` (bounds the teacher's
    activations on millions of observations), numpy out."""
    outs = [fn(torch.from_numpy(np.ascontiguousarray(arr[i:i + chunk]))
               .to(device)).detach().cpu().numpy()
            for i in range(0, arr.shape[0], chunk)]
    return (np.concatenate(outs) if outs
            else np.zeros((0, ACTION_DIM), np.float32))


def _shoot(scene, table, obs: torch.Tensor, actions: torch.Tensor,
           small_radius_below: float):
    """Each action, clipped, shot from its observation's surface point
    (offset 0.001 along the normal) through the nearest-hit sweep (``|t|``,
    nothing suppressed): ``(point, normal, idx, emis, small)``."""
    point, normal = obs[:, 0:3], obs[:, 6:9]
    direction = fb_action_to_direction(torch.clamp(actions, -1.0, 1.0),
                                       normal, "renderer")
    _, idx, found = cuda_intersect.nearest_hit(
        (point + normal * 0.001).contiguous(), direction.contiguous(), None,
        table, by_abs=True)
    i = idx.long()
    emis = found & (scene.emitive[i] > 0)
    small = emis & (scene.radius[i] < small_radius_below)
    return point, normal, i, emis, small


def _action_outcomes(scene, obs: np.ndarray, actions: np.ndarray, *,
                     small_radius_below: float = 0.5, device=None,
                     chunk: int = 1 << 19):
    """Did each action, shot from its observation's surface point, land on
    an emissive sphere / on a *small* one (the deployment metric)?
    ``(emis, small)`` numpy bools."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    table = sphere_table(scene)
    emis_out, small_out = [], []
    for i in range(0, obs.shape[0], chunk):
        o = torch.from_numpy(np.ascontiguousarray(obs[i:i + chunk],
                                                  np.float32)).to(dev)
        a = torch.from_numpy(np.ascontiguousarray(actions[i:i + chunk],
                                                  np.float32)).to(dev)
        _, _, _, e, s = _shoot(scene, table, o, a, small_radius_below)
        emis_out.append(e.cpu().numpy())
        small_out.append(s.cpu().numpy())
    if not emis_out:
        return np.zeros(0, bool), np.zeros(0, bool)
    return np.concatenate(emis_out), np.concatenate(small_out)


def light_hit_weights(scene, obs: np.ndarray, actions: np.ndarray, *,
                      bonus: float = 9.0, small_radius_below: float = 0.5,
                      device=None) -> np.ndarray:
    """Imitation weights: 1, plus ``bonus`` where the teacher's action
    lands on an emissive sphere and ``bonus`` more on a small one (JAX
    ``light_hit_weights`` :153: the lanes where the teacher aims at a light
    are the ones the student must copy to sub-0.01 action error)."""
    emis, small = _action_outcomes(scene, obs, actions, device=device,
                                   small_radius_below=small_radius_below)
    return (1.0 + bonus * emis + bonus * small).astype(np.float32)


def best_of_teachers_targets(scene, obs: np.ndarray, teacher_fns, *,
                             bonus: float = 9.0,
                             small_radius_below: float = 0.5, device=None):
    """Per-observation target chosen among several teachers by measured
    outcome (JAX ``best_of_teachers_targets`` :167): each teacher's
    clipped action scored small-light hit (2) > light hit (1) > miss (0),
    the first teacher winning ties.  Returns ``(targets, weights)``.  (JAX's
    measurements: one-step selection raises the aimed-hit rate but lowers
    the rendered improvement; ``hindsight_aim_targets`` is the one that
    works.)"""
    if not teacher_fns:
        raise ValueError("best_of_teachers_targets needs a teacher")
    dev = resolve_device(device)
    acts, scores = [], []
    for fn in teacher_fns:
        a = np.clip(_chunked(fn, obs, dev), -1.0, 1.0)
        emis, small = _action_outcomes(scene, obs, a, device=dev,
                                       small_radius_below=small_radius_below)
        acts.append(a)
        scores.append(emis.astype(np.int32) + small.astype(np.int32))
    scores = np.stack(scores)                       # [T, N]
    best = np.argmax(scores, axis=0)                # first teacher wins ties
    rows = np.arange(obs.shape[0])
    targets = np.stack(acts)[best, rows]
    sel = scores[best, rows]
    weights = (1.0 + bonus * (sel >= 1) + bonus * (sel >= 2)
               ).astype(np.float32)
    print("best_of_teachers: per-teacher hit rates "
          f"any={np.round((scores >= 1).mean(axis=1), 4).tolist()} "
          f"small={np.round((scores >= 2).mean(axis=1), 4).tolist()} | "
          f"selected any={float((sel >= 1).mean()):.4f} "
          f"small={float((sel >= 2).mean()):.4f} | win share "
          f"{[float((best == t).mean()) for t in range(len(teacher_fns))]}",
          flush=True)
    return targets.astype(np.float32), weights


def hindsight_aim_targets(scene, obs: np.ndarray, actions: np.ndarray, *,
                          small_radius_below: float = 0.5,
                          bonus: float = 9.0, device=None,
                          chunk: int = 1 << 19):
    """Hindsight aim-sharpening (JAX ``hindsight_aim_targets`` :216): where
    the teacher's action lands on an emissive sphere, the target becomes
    the exact aim at that sphere's centre (``direction_to_action``,
    renderer frame); elsewhere the teacher's action stays.  Returns
    ``(targets clipped to [-1, 1], weights)``."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    table = sphere_table(scene)
    targets = np.empty_like(np.asarray(actions, np.float32))
    w = np.empty(obs.shape[0], np.float32)
    for i in range(0, obs.shape[0], chunk):
        o = torch.from_numpy(np.ascontiguousarray(obs[i:i + chunk],
                                                  np.float32)).to(dev)
        a = torch.from_numpy(np.ascontiguousarray(actions[i:i + chunk],
                                                  np.float32)).to(dev)
        point, normal, idx, emis, small = _shoot(scene, table, o, a,
                                                 small_radius_below)
        aim = scene.centre[idx] - point
        aim = aim / vec.magnitude_c(*aim.unbind(-1))[:, None]
        sharp = direction_to_action(aim, normal, convention="renderer")
        targets[i:i + chunk] = torch.where(emis[:, None], sharp,
                                           a).cpu().numpy()
        w[i:i + chunk] = (1.0 + bonus * emis.float()
                          + bonus * small.float()).cpu().numpy()
    return np.clip(targets, -1.0, 1.0), w


def cosine_decay_lr(learning_rate: float, step: int, decay_steps: int,
                    alpha: float = 1e-3) -> float:
    """optax ``cosine_decay_schedule(learning_rate, decay_steps, alpha)``
    at ``step``: ``lr * ((1 - alpha) * 0.5 * (1 + cos(pi * t / T)) +
    alpha)`` with ``t = min(step, T)``."""
    t = min(step, decay_steps)
    cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
    return learning_rate * ((1 - alpha) * cosine + alpha)


def init_student_params(hidden: Sequence[int], generator: torch.Generator,
                        obs_dim: int = OBS_DIM,
                        action_dim: int = ACTION_DIM) -> dict:
    """flax's initial values for ``StudentPolicy`` (lecun-normal kernels,
    zero biases), drawn by ``generator``: ``{"Dense_i": {"kernel", "bias"}}``
    numpy float32."""
    dims = (obs_dim,) + tuple(hidden) + (action_dim,)
    return {f"Dense_{i}": {
        "kernel": _lecun_normal((a, b), a, generator).numpy(),
        "bias": np.zeros(b, np.float32)}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


def _params_of(module: "StudentPolicy") -> dict:
    return {f"Dense_{i}": {
        "kernel": layer.weight.detach().t().contiguous().cpu().numpy(),
        "bias": layer.bias.detach().cpu().numpy().copy()}
        for i, layer in enumerate(module.layers)}


def distill(teacher_guide_fn: Optional[Callable], obs: np.ndarray, *,
            seed: int = 0, hidden: Tuple[int, ...] = (64, 64),
            epochs: int = 30, batch_size: int = 65536,
            learning_rate: float = 3e-3, jitter: float = 0.02,
            weights: Optional[np.ndarray] = None, weight_fn=None,
            target_fn=None, targets: Optional[np.ndarray] = None,
            init_params: Optional[Mapping] = None,
            device=None) -> DistillResult:
    """Fit a student to the teacher's actions on ``obs`` plus jittered
    copies (JAX ``distill`` :268): the weighted MSE ``sum(w · |pred -
    target|²) / max(sum(w), 1e-9)``, Adam under the cosine decay to
    ``1e-3 · learning_rate`` over ``epochs · max(1, n // batch_size)``
    steps, one permutation an epoch.  ``np.random.default_rng(seed)``
    draws the jitter and the permutations in JAX's order.  Targets: the
    teacher's clipped actions (``weight_fn(obs, targets)`` for weights), or
    ``target_fn(obs) -> (targets, weights)`` after jittering, or
    precomputed ``targets`` (copies inherit their original's label).
    ``init_params``: the student's initial values in JAX's layout (else
    flax's initialisers on a ``torch.Generator`` seeded ``seed``).  Runs on
    ``device``; the teacher gets tensors there."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    obs = np.asarray(obs, np.float32)
    if jitter > 0:
        obs = np.concatenate(
            [obs, obs + rng.normal(scale=jitter,
                                   size=obs.shape).astype(np.float32)])
    if targets is not None:
        target = np.asarray(targets, np.float32)
        if weights is not None:
            weights = np.asarray(weights, np.float32)
        if jitter > 0:
            target = np.concatenate([target, target])
            if weights is not None:
                weights = np.concatenate([weights, weights])
    elif target_fn is not None:
        target, weights = target_fn(obs)
    else:
        target = np.clip(_chunked(teacher_guide_fn, obs, dev), -1.0, 1.0)
        if weights is None and weight_fn is not None:
            weights = weight_fn(obs, target)
    weights = (np.ones(obs.shape[0], np.float32) if weights is None
               else np.asarray(weights, np.float32))
    t1 = time.perf_counter()

    obs_t = torch.from_numpy(obs).to(dev)
    target_t = torch.from_numpy(np.asarray(target, np.float32)).to(dev)
    weights_t = torch.from_numpy(weights).to(dev)
    if init_params is None:
        init_params = init_student_params(
            hidden, torch.Generator().manual_seed(seed), obs.shape[1])
    student = StudentPolicy(hidden, obs.shape[1]).to(dev)
    student.load_state_dict({k: v.to(dev) for k, v in
                             state_dict_from_params(init_params).items()})
    n = obs.shape[0]
    steps_per_epoch = max(1, n // batch_size)
    decay_steps = epochs * steps_per_epoch
    opt = torch.optim.Adam(student.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    step, loss = 0, None
    for _ in range(epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        for i in range(0, n - batch_size + 1, batch_size) or [0]:
            idx = perm[i:i + batch_size]
            for group in opt.param_groups:
                group["lr"] = cosine_decay_lr(learning_rate, step,
                                              decay_steps)
            w = weights_t[idx]
            se = ((student(obs_t[idx]) - target_t[idx]) ** 2).sum(dim=-1)
            loss = (w * se).sum() / torch.clamp_min(w.sum(), 1e-9)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            step += 1
    final_loss = loss.item() if loss is not None else float("inf")
    return DistillResult(params=_params_of(student), hidden=tuple(hidden),
                         final_loss=final_loss, n_obs=n, steps=step,
                         seconds={"targets": t1 - t0,
                                  "train": time.perf_counter() - t1})


def _collect_both_aspects(scene, teacher, generators, *, frames,
                          camera_position, device):
    """The teacher's observations at 128x64 (2:1, the reference's 200x100
    comparisons) and 96x72 (4:3, the 800x600 renders)."""
    wide = collect_observations(scene, teacher, frames=frames, width=128,
                                height=64, camera_position=camera_position,
                                generator=generators[0], device=device)
    tall = collect_observations(scene, teacher, frames=frames, width=96,
                                height=72, camera_position=camera_position,
                                generator=generators[1], device=device)
    return [wide, tall]


def _generators(seed: int, n: int, device):
    seeds = np.random.SeedSequence(seed).generate_state(n)
    return [torch.Generator(device).manual_seed(int(s)) for s in seeds]


def distill_agent(agent, scene, *, seed: int = 0,
                  camera_position=(0.0, 2.0, 0.0), frames: int = 4,
                  epochs: int = 30, hidden: Tuple[int, ...] = (64, 64),
                  extra_obs: Optional[np.ndarray] = None,
                  hit_weight_bonus: float = 9.0,
                  hindsight_sharpen: bool = False
                  ) -> Tuple[DistilledGuide, DistillResult]:
    """One-call distillation of a ``TrainedFBAgent`` on its scene (JAX
    ``distill_agent`` :432), on the agent's device: observations at both
    deployment aspects under the f32 teacher's guided renders (two
    generators seeded from ``seed``), light-hit-weighted imitation, or
    with ``hindsight_sharpen`` the hindsight aim targets."""
    dev = agent.device
    teacher = agent.as_guide_fn(dtype=None)
    t0 = time.perf_counter()
    obs = np.concatenate(_collect_both_aspects(
        scene, teacher, _generators(seed, 2, dev), frames=frames,
        camera_position=camera_position, device=dev))
    collect_s = time.perf_counter() - t0
    if extra_obs is not None and len(extra_obs):
        obs = np.concatenate([obs, np.asarray(extra_obs, np.float32)])
    target_fn = weight_fn = None
    if hindsight_sharpen:
        def target_fn(o):
            acts = np.clip(_chunked(teacher, o, dev), -1.0, 1.0)
            return hindsight_aim_targets(scene, o, acts,
                                         bonus=hit_weight_bonus, device=dev)
    elif hit_weight_bonus > 0:
        def weight_fn(o, a):
            return light_hit_weights(scene, o, a, bonus=hit_weight_bonus,
                                     device=dev)
    res = distill(teacher, obs, seed=seed, hidden=hidden, epochs=epochs,
                  weight_fn=weight_fn, target_fn=target_fn, device=dev)
    res.seconds["collect"] = collect_s
    return DistilledGuide(res.params, res.hidden), res


def distill_ensemble(agents, scene, *, seed: int = 0,
                     camera_position=(0.0, 2.0, 0.0), frames: int = 4,
                     epochs: int = 30, hidden: Tuple[int, ...] = (128, 128),
                     hit_weight_bonus: float = 9.0
                     ) -> Tuple[DistilledGuide, DistillResult]:
    """Several agents into one student with per-observation
    outcome-selected targets (JAX ``distill_ensemble`` :477): observations
    under every teacher's own renders at both aspects; the first agent is
    the primary (it wins ties)."""
    dev = agents[0].device
    teachers = [a.as_guide_fn(dtype=None) for a in agents]
    gens = _generators(seed, 2 * len(teachers), dev)
    t0 = time.perf_counter()
    pools = []
    for t, teacher in enumerate(teachers):
        pools += _collect_both_aspects(scene, teacher, gens[2 * t:2 * t + 2],
                                       frames=frames,
                                       camera_position=camera_position,
                                       device=dev)
    obs = np.concatenate(pools)

    def target_fn(o):
        return best_of_teachers_targets(scene, o, teachers,
                                        bonus=hit_weight_bonus, device=dev)

    collect_s = time.perf_counter() - t0
    res = distill(None, obs, seed=seed, hidden=hidden, epochs=epochs,
                  target_fn=target_fn, device=dev)
    res.seconds["collect"] = collect_s
    return DistilledGuide(res.params, res.hidden), res
