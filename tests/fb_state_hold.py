"""JAX's whole FB trainer state carried into the port's trainer, and the
shipped chandelier protocol held to JAX scene by scene at full width.

Helpers (tests/test_torch_fb_chunk_hold.py imports them):

* ``jax_state(tr)`` copies a JAX ``ChandelierOnlyTrainer``'s training
  state: the four networks' parameters, optax's Adam state, the replay
  ring (its five arrays, ``size`` and ``pos``), the replay generator's
  state, the light memory, the noise scale, the record and update counts,
  the statistics and the trainer's key.  ``set_jax_state(tr, st)`` puts
  it back, so one scene can be replayed from the same start.
* ``carry(st, tr)`` sets a port trainer's agent from such a state, all
  through numpy: the parameters through ``utils/checkpoint.py::load_flat``
  naming, Adam's ``mu``, ``nu`` and ``count`` as ``torch.optim.Adam``'s
  ``exp_avg``, ``exp_avg_sq`` and ``step`` parameter by parameter, the
  ring, the generator state and the counters.
* ``keyed(tr, key)`` makes the port's walk draw its planes from JAX's key
  schedule (``tests/test_torch_fb_walk.py::jax_walk_draws``);
  ``scene_key(st)`` is the key JAX's ``train_on_scene`` splits off for
  the next scene.
* ``walks(module, op_by_op)`` records each walk a trainer module's
  ``generate_trajectories`` returns (JAX's under ``jax.disable_jit()``
  when ``op_by_op``); ``fed(module, walk)`` makes a trainer module take
  JAX's walk instead of walking; ``jax_outcome``/``port_outcome`` read what a
  scene left (the live guide through ``guide_on``, the port's arithmetic
  for both packages' parameters); ``compare`` sets two outcomes side by
  side.

As a script it runs JAX's trainer jitted, as production does, through the
chunk loop of ``scripts/ship_models.py::cmd_train_chandelier``
(``--scenes`` 320: 80 / 80 / 160 scenes at ``guide_prob`` 0 / 0.25 /
0.5, 200 walkers, ``FBConfig(max_bounces=8, f_hidden_dim=512,
b_hidden_dim=256)``, wall fraction 0.35), and at each snapshot scene
replays that scene from JAX's state before it:

* (a) JAX jitted: the production run's own scene;
* (b) JAX with the walk op by op (``jax.disable_jit()``), its guide and
  the updates jitted as in production;
* (c) the port as shipped, on the CPU;
* (d) the port with XLA's float32 ``sin``, ``cos``, ``acos``, ``atan2``
  and ``log1p`` patched into torch (``XLA_MATH``);
* twin: (c) with its encoder one ulp up;
* (e) the port fed (a)'s walk (``fed``): its recording and its updates
  on exactly JAX's transitions; e_twin and e_down: (e) with its encoder
  one ulp up and one ulp down; a_eager: JAX fed (a)'s walk with its
  updates op by op.

Every port side walks on JAX's draws for the scene.  The snapshots are
global scenes 0, 40, 80, 120, the scene in which the ring first reaches
its capacity and the one after it, 160, then every 10th to 310.  Each
row holds the comparisons of ``PAIRS`` and two readings of them,
``fault`` and ``fault_ulp`` (``faults``).

    python tests/fb_state_hold.py --seed 0 --scenes 320 \\
        --out ROWS.json --workdir DIR

It writes one JSON row a snapshot to ``--out`` and prints a summary line a
snapshot; ``--summarize ROWS.json ...`` prints what several runs show
together, with a markdown row a held scene.  With ``--updates-at G`` it trains to global scene G and holds
``--update-steps`` replay updates there instead (``hold_updates``):
where the port's updates first part from JAX's on one state and one ring,
and why.  A 320-scene hold took 2,786–2,837 s, two seeds at once on an
8-core host (~76 s a held scene); ``--updates-at 2 --scenes 4`` ~3 min.
"""
import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import raytracer_tpu.fb.trainer as jax_trainer_mod  # noqa: E402
import raytracer_tpu_torch.fb.trainer as port_trainer_mod  # noqa: E402
from raytracer_tpu.utils.checkpoint import _flatten  # noqa: E402
from raytracer_tpu_torch.fb.agent import loss_terms  # noqa: E402
from raytracer_tpu_torch.fb.config import FBConfig  # noqa: E402
from raytracer_tpu_torch.fb.inference import AgentGuide  # noqa: E402
from raytracer_tpu_torch.fb.trajectory import TrajectoryBatch  # noqa: E402
from raytracer_tpu_torch.utils.checkpoint import (  # noqa: E402
    PARTS, load_flat, params_from_flat)

from test_torch_fb_learner import jax_flat, port_flat  # noqa: E402
from test_torch_fb_train_run import XLA_MATH, _jitted, _xla  # noqa: E402
from test_torch_fb_walk import jax_walk_draws  # noqa: E402

RING = ("obs", "action", "next_obs", "reward", "hit_light")
FLAGS = ("valid", "hit_light", "hit_small", "episode_hit")
LEARNED = ("encoder", "forward", "backward")
FACTOR = 2.0
GUIDE_ROWS = 2048


# -- state -----------------------------------------------------------------
def jax_state(tr) -> dict:
    """A copy of JAX trainer ``tr``'s training state."""
    ag, b = tr.agent, tr.agent.buffer
    return {"params": ag.params, "opt_state": ag.opt_state,
            "ring": {f: getattr(b, f).copy() for f in RING},
            "size": b.size, "pos": b.pos,
            "rng": copy.deepcopy(ag.rng.bit_generator.state),
            "light_memory": [np.array(r) for r in ag.light_memory],
            "noise": ag.noise_scale, "records": ag.records,
            "updates": ag.updates, "stats": dict(ag.stats),
            "key": tr._key,
            "history": (len(ag.losses), len(ag.head_var_history))}


def _set_agent(ag, st: dict) -> None:
    """The ring, the replay generator, the light memory and the counters
    of agent ``ag`` (either package's) from ``st``."""
    b = ag.buffer
    assert b.capacity == len(st["ring"]["obs"])
    for f in RING:
        getattr(b, f)[...] = st["ring"][f]
    b.size, b.pos = st["size"], st["pos"]
    ag.rng.bit_generator.state = copy.deepcopy(st["rng"])
    ag.light_memory = [r.copy() for r in st["light_memory"]]
    ag.noise_scale, ag.records = st["noise"], st["records"]
    ag.updates, ag.stats = st["updates"], dict(st["stats"])


def set_jax_state(tr, st: dict) -> None:
    """Put ``st`` (from ``jax_state``) back into JAX trainer ``tr``."""
    ag = tr.agent
    ag.params, ag.opt_state = st["params"], st["opt_state"]
    _set_agent(ag, st)
    tr._key = st["key"]
    n_loss, n_var = st["history"]
    del ag.losses[n_loss:], ag.head_var_history[n_var:]


@torch.no_grad()
def carry(st: dict, tr) -> None:
    """Port trainer ``tr``'s agent set from JAX's state ``st``."""
    ag = tr.agent
    flat = jax_flat(st["params"], PARTS)
    for part, net in ag.nets.items():
        load_flat(net, flat, part + "::")
    adam, = (s for s in st["opt_state"] if hasattr(s, "mu"))
    step = float(int(adam.count))
    ag.optimizer.state.clear()
    for part, mu, nu in zip(LEARNED, adam.mu, adam.nu):
        fm, fv = _flatten(mu), _flatten(nu)
        for name, p in ag.nets[part].named_parameters():
            k = name.replace(".", "/")
            ag.optimizer.state[p] = {
                "step": torch.tensor(step),
                "exp_avg": torch.tensor(np.array(fm[k])).to(p.device),
                "exp_avg_sq": torch.tensor(np.array(fv[k])).to(p.device)}
    _set_agent(ag, st)


@torch.no_grad()
def bump_encoder(agent, toward: float = np.inf) -> None:
    """The encoder's parameters one ulp up (toward ``-inf``: down), a
    twin's start."""
    for p in agent.encoder.parameters():
        p.copy_(torch.nextafter(p, torch.full_like(p, toward)))


def scene_key(st: dict):
    """The key JAX's ``train_on_scene`` walks the next scene on."""
    return jax.random.split(st["key"])[1]


def keyed(tr, key) -> None:
    """Port trainer ``tr`` walks on JAX's draws from ``key``."""
    tr.walk_draws = lambda episodes, scene, guided: jax_walk_draws(
        key, episodes, scene.num_spheres, tr.config.max_bounces,
        tr.START_BIAS, guided)


@contextlib.contextmanager
def walks(module, op_by_op: bool = False):
    """``(walk, guided)`` for each walk ``module.generate_trajectories``
    returns inside the block; with ``op_by_op``, JAX's walk runs op by op
    with its guide jitted, as inside the jitted walk (flax's eager apply
    compiles each of its operations at first use)."""
    seen = []
    orig = module.generate_trajectories

    def capture(*a, **kw):
        if op_by_op:
            if kw.get("guide_apply") is not None:
                kw["guide_apply"] = _jitted(kw["guide_apply"])
            with jax.disable_jit():
                w = orig(*a, **kw)
        else:
            w = orig(*a, **kw)
        seen.append((w, kw.get("guide", kw.get("guide_apply")) is not None))
        return w
    module.generate_trajectories = capture
    try:
        yield seen
    finally:
        module.generate_trajectories = orig


@contextlib.contextmanager
def fed(module, walk):
    """A trainer module's walk replaced by JAX's ``walk``: inside the
    block its trainer records and trains on exactly JAX's transitions."""
    if module is port_trainer_mod:
        walk = TrajectoryBatch(*(torch.from_numpy(np.array(getattr(walk, f)))
                                 for f in TrajectoryBatch._fields))
    orig = module.generate_trajectories
    module.generate_trajectories = lambda *a, **kw: walk
    try:
        yield
    finally:
        module.generate_trajectories = orig


@contextlib.contextmanager
def xla_math():
    """XLA's float32 transcendentals patched into torch."""
    with pytest.MonkeyPatch.context() as mp:
        for name, jname in XLA_MATH.items():
            mp.setattr(torch, name, _xla(jname))
        yield


# -- outcomes --------------------------------------------------------------
def _outcome(ag, pre, walk, params, guide) -> dict:
    b = ag.buffer
    n = ag.records - pre["records"]
    rows = (pre["pos"] + np.arange(n)) % b.capacity
    flags = {f: np.asarray(getattr(walk, f)) for f in FLAGS}
    return {"flags": flags,
            "hits": int(flags["episode_hit"].sum()),
            "small_hits": int(flags["hit_small"].any(axis=0).sum()),
            "records": n, "updates": ag.updates - pre["updates"],
            "size": b.size, "pos": b.pos,
            "rng": copy.deepcopy(ag.rng.bit_generator.state),
            "noise": ag.noise_scale, "stats": dict(ag.stats),
            "light_memory": np.array(ag.light_memory),
            "proto": ag.light_prototype(),
            "written": {f: getattr(b, f)[rows].copy() for f in RING},
            "params": params, "guide": guide}


def guide_on(flat: dict, proto, config, rows) -> np.ndarray:
    """The guide of the parameters ``flat`` (flax's names) against
    ``proto`` on ``rows``, in the port's arithmetic: the parameters of two
    sides compared through one evaluation and one prototype, so the gap is
    theirs and not that of two summation orders (the prototypes, each
    side's encoder's latents, are compared apart)."""
    nets = params_from_flat(flat, config)
    guide = AgentGuide(nets["encoder"], nets["backward"],
                       torch.from_numpy(np.asarray(proto)), config.z_dim)
    with torch.no_grad():
        return guide(torch.from_numpy(rows)).numpy()


def jax_outcome(tr, pre, walk, rows, proto) -> dict:
    """What JAX trainer ``tr``'s scene from ``pre`` left; its guide on
    ``rows`` against the prototype ``proto`` (``guide_on``)."""
    ag = tr.agent
    flat = jax_flat(ag.params, PARTS)
    config = FBConfig(**ag.config.to_dict())
    return _outcome(ag, pre, walk, flat,
                    guide_on(flat, proto, config, rows))


def port_outcome(tr, pre, walk, rows, proto) -> dict:
    """``jax_outcome`` for a port trainer."""
    ag = tr.agent
    flat = port_flat(ag, PARTS)
    return _outcome(ag, pre, walk, flat,
                    guide_on(flat, proto, ag.config, rows))


def _gap(x, y) -> float:
    if x.shape != y.shape:
        return float("inf")
    return float(np.abs(x.astype(np.float64) - y).max()) if x.size else 0.0


def param_gaps(x: dict, y: dict, start: dict | None = None) -> dict:
    """Flattened parameters ``x`` against ``y``: the largest gap and where
    it lies, and with the parameters ``start`` that both left, the gap's
    norm over the norm of ``y``'s move from ``start`` (``param_rel_l2``,
    else None)."""
    gaps = {k: _gap(x[k], y[k]) for k in y}
    rel_l2 = None
    if start is not None:
        num = sum(float(np.sum((x[k].astype(np.float64) - y[k]) ** 2))
                  for k in start)
        den = sum(float(np.sum((y[k].astype(np.float64) - start[k]) ** 2))
                  for k in start)
        rel_l2 = float(np.sqrt(num / den)) if den else float("inf")
    return {"param_gap": max(gaps.values()),
            "param_gap_at": max(gaps, key=gaps.get),
            "param_rel_l2": rel_l2}


def compare(x: dict, y: dict, start: dict | None = None) -> dict:
    """Outcome ``x`` against ``y``: differing flag entries, whether the
    counters, ring position and generator state agree, the written ring
    rows' largest difference relative to ``max(|y|, 1)``, the parameter
    gaps (``param_gaps``) and the largest guide, light memory and
    prototype gaps."""
    flags = {f: int((x["flags"][f] != y["flags"][f]).sum()) for f in FLAGS}
    counters = all(x[k] == y[k] for k in ("records", "updates", "size",
                                           "pos", "noise", "stats"))
    rel = float("inf")
    if x["records"] == y["records"]:
        rel = max((float((np.abs(x["written"][f].astype(np.float64)
                                 - y["written"][f])
                          / np.maximum(np.abs(y["written"][f]), 1.0)).max())
                   if y["records"] else 0.0) for f in RING)
    return {"flags": flags, "flag_diff": sum(flags.values()),
            "counters": counters, "rng": x["rng"] == y["rng"],
            "ring_rel": rel,
            **param_gaps(x["params"], y["params"], start),
            "guide_gap": _gap(x["guide"], y["guide"]),
            "memory_gap": _gap(x["light_memory"], y["light_memory"]),
            "proto_gap": _gap(x["proto"], y["proto"])}


# -- the script --------------------------------------------------------------
def _port_trainer(cfg, seed, workdir, name):
    return port_trainer_mod.ChandelierOnlyTrainer(
        num_training_scenes=1, config=cfg, output_dir=workdir / name,
        seed=seed, device="cpu")


def hold_scene(jt, sides, pre, walk_a, scene_args, g):
    """Replay global scene ``g`` from ``pre`` in (b) and the port sides;
    JAX's trainer ends in its production state again.  Returns the row."""
    t0 = time.perf_counter()
    scene, name, episodes = scene_args
    post = jax_state(jt)
    obs = np.asarray(walk_a.obs).reshape(-1, 22)
    rows = obs[np.asarray(walk_a.valid).reshape(-1)][:GUIDE_ROWS]
    proto = jt.agent.light_prototype()
    out = {"a": jax_outcome(jt, pre, walk_a, rows, proto)}
    set_jax_state(jt, pre)
    with walks(jax_trainer_mod, op_by_op=True) as seen:
        type(jt).train_on_scene(jt, scene, name, episodes)
    out["b"] = jax_outcome(jt, pre, seen[-1][0], rows, proto)
    set_jax_state(jt, pre)
    with fed(jax_trainer_mod, walk_a), jax.disable_jit():
        type(jt).train_on_scene(jt, scene, name, episodes)
    out["a_eager"] = jax_outcome(jt, pre, walk_a, rows, proto)
    set_jax_state(jt, post)
    variation = int(name.rsplit("_v", 1)[1])
    key = scene_key(pre)
    for side, tr in sides.items():
        carry(pre, tr)
        if side in ("twin", "e_twin"):
            bump_encoder(tr.agent)
        elif side == "e_down":
            bump_encoder(tr.agent, -np.inf)
        tr.guide_prob, tr.WALL_FRAC = jt.guide_prob, jt.WALL_FRAC
        keyed(tr, key)
        pscene = tr.make_scene(variation)[0]
        with contextlib.ExitStack() as stack:
            if side == "d":
                stack.enter_context(xla_math())
            if side.startswith("e"):
                stack.enter_context(fed(port_trainer_mod, walk_a))
            seen = stack.enter_context(walks(port_trainer_mod))
            tr.train_on_scene(pscene, name, episodes)
        out[side] = port_outcome(tr, pre, seen[-1][0], rows, proto)
    start = jax_flat(pre["params"], PARTS)
    cmp_ = {f"{x}-{y}": compare(out[x], out[y], start) for x, y in PAIRS}
    slack = 2 * (3 * jt.config.max_bounces + 1)
    return {"scene": g, "name": name, "guide_prob": jt.guide_prob,
            "pre": {"size": pre["size"], "pos": pre["pos"],
                    "updates": pre["updates"], "noise": pre["noise"],
                    "memory": len(pre["light_memory"])},
            "records": out["a"]["records"], "updates": out["a"]["updates"],
            "size": out["a"]["size"], "pos": out["a"]["pos"],
            "hits": {s: o["hits"] for s, o in out.items()},
            "small_hits": {s: o["small_hits"] for s, o in out.items()},
            "compare": cmp_, "slack": slack,
            "fault": faults(cmp_, slack),
            "fault_ulp": faults(cmp_, slack, ulp_only=True),
            "seconds": time.perf_counter() - t0}


# (x, y): side x against side y.
PAIRS = (("b", "a"), ("c", "a"), ("c", "b"), ("d", "a"), ("d", "b"),
         ("twin", "c"), ("e", "a"), ("e_twin", "e"), ("e_down", "e"),
         ("a_eager", "a"))


def faults(c: dict, slack: int, ulp_only: bool = False) -> list:
    """What reads as a fault in a held scene's comparisons ``c``.

    Both readings: (d)'s flags differ from (b)'s; (c) differs from (a) in
    more flag entries than (b) does, plus ``slack``; (d)'s counters or
    generator state differ from (b)'s, or (c)'s from (a)'s where their
    flags agree.  Then the updates.  With ``ulp_only``: (c)'s largest
    parameter gap or guide gap from (a) over ``FACTOR`` times the ulp
    twin's from (c); that twin's gap leaves out the walk's own rounding
    (a guided walk of 8 bounces carries the guide's summation order from
    step to step, which an ulp of the encoder does not reproduce).  By
    default: the port fed (a)'s walk (e) must write JAX's ring rows bit
    for bit and match its counters and generator, and its parameters'
    ``param_rel_l2`` and its guide gap from (a) must stay within
    ``FACTOR`` times the largest of its two ulp twins' (up and down) from
    (e) and of JAX's own gap between its jitted updates and the same
    updates op by op on the same walk (a_eager: XLA's rounding of one
    computation in two orders).  The largest single parameter gap is
    printed beside it: a ReLU branch that flips on a rounding lets Adam
    move a whole unit's weights by about the learning rate, so that
    maximum is any twin's."""
    out = []
    if c["d-b"]["flag_diff"]:
        out.append("flags d-b")
    if c["c-a"]["flag_diff"] > c["b-a"]["flag_diff"] + slack:
        out.append("flags c-a")
    if not (c["d-b"]["counters"] and c["d-b"]["rng"]):
        out.append("counters d-b")
    if c["c-a"]["flag_diff"] == 0 and not (c["c-a"]["counters"]
                                           and c["c-a"]["rng"]):
        out.append("counters c-a")
    if ulp_only:
        for gap in ("param_gap", "guide_gap"):
            if c["c-a"][gap] > FACTOR * c["twin-c"][gap]:
                out.append(f"{gap} c-a")
        return out
    e = c["e-a"]
    if e["flag_diff"] or not (e["counters"] and e["rng"]) or e["ring_rel"]:
        out.append("ring e-a")
    for gap in ("param_rel_l2", "guide_gap"):
        scale = max(c["e_twin-e"][gap], c["e_down-e"][gap],
                    c["a_eager-a"][gap])
        if e[gap] > FACTOR * scale:
            out.append(f"{gap} e-a")
    return out


SNAPSHOTS = {0, 40, 80, 120, 160, *range(170, 320, 10)}
WALKERS = 200
# PyTorch's threads: two scripts at once share an 8-core host.
THREADS = 2
PARTING = 5e-7


def _moments(ag) -> dict:
    """Adam's first and second moments of an agent of either package,
    under flax's flattened names."""
    if hasattr(ag, "opt_state"):
        adam, = (s for s in ag.opt_state if hasattr(s, "mu"))
        return {f"{part}::{k}": (np.asarray(m), np.asarray(v))
                for part, tm, tv in zip(LEARNED, adam.mu, adam.nu)
                for (k, m), v in zip(_flatten(tm).items(),
                                     _flatten(tv).values())}
    return {f"{part}::{n.replace('.', '/')}": (
        ag.optimizer.state[p]["exp_avg"].numpy().copy(),
        ag.optimizer.state[p]["exp_avg_sq"].numpy().copy())
        for part in LEARNED for n, p in ag.nets[part].named_parameters()}


def hold_updates(jt, port, twin, steps: int) -> list:
    """``steps`` replay updates from JAX trainer ``jt``'s state on its own
    ring, in JAX, the port and the port's ulp twin (both carried from that
    state): after each, the port's and the twin's largest parameter gap
    and ``param_rel_l2``; at the first update whose gap from JAX passes
    ``PARTING``, the entries that part, with each package's gradient there
    (from Adam's first moment), the same update's gradient in float64 in
    each package (``_grad64``, ``_jax_grad64``), JAX's in float64 at the
    port's parameters, and each second moment before it.  JAX's
    trainer ends in its state again."""
    post = jax_state(jt)
    carry(post, port)
    carry(post, twin)
    bump_encoder(twin.agent)
    start = jax_flat(post["params"], PARTS)
    rows, parted = [], False
    for _ in range(steps):
        before = {"jax": _moments(jt.agent), "port": _moments(port.agent)}
        nets = copy.deepcopy(port.agent.nets)
        rng = copy.deepcopy(port.agent.rng)
        jax_before = (jt.agent.params, jt.agent.opt_state)
        for ag in (jt.agent, port.agent, twin.agent):
            ag.train_step()
        flat = {"jax": jax_flat(jt.agent.params, PARTS),
                "port": port_flat(port.agent, PARTS),
                "twin": port_flat(twin.agent, PARTS)}
        row = {"update": jt.agent.updates}
        for x, y in (("port", "jax"), ("twin", "port")):
            row[f"{x}-{y}"] = param_gaps(flat[x], flat[y], start)
        if not parted and row["port-jax"]["param_gap"] > PARTING:
            parted = True
            row["parting"] = _parting(
                jt.agent, port.agent, flat, before, jax_before, nets, rng)
        rows.append(row)
        print(json.dumps(row, default=int), flush=True)
    set_jax_state(jt, post)
    return rows


def _parting(jax_agent, port_agent, flat, before, jax_before, nets,
             rng) -> list:
    """The (at most 8) entries whose gap from JAX passed ``PARTING`` in
    the update just run from ``before`` (both packages' Adam moments),
    ``jax_before`` (JAX's parameters and optimiser state), ``nets`` and
    ``rng`` (the port's networks and replay generator): each package's
    gradient there, the float64 ones and the second moments."""
    b1 = 0.9
    after = {"jax": _moments(jax_agent), "port": _moments(port_agent)}
    entries = []
    for k in flat["jax"]:
        if k.startswith("target_encoder::"):
            continue
        d = np.abs(flat["port"][k].astype(np.float64) - flat["jax"][k])
        for j in np.argsort(d.ravel())[::-1][:8]:
            if d.ravel()[j] <= PARTING:
                break
            entries.append({
                "param": k, "index": np.unravel_index(j, d.shape),
                "gap": float(d.ravel()[j]),
                "grad": {s: float((after[s][k][0].ravel()[j]
                                   - b1 * before[s][k][0].ravel()[j])
                                  / (1 - b1)) for s in ("jax", "port")},
                "nu_before": {s: float(before[s][k][1].ravel()[j])
                              for s in ("jax", "port")}})
    entries = sorted(entries, key=lambda e: -e["gap"])[:8]
    batch = port_agent.buffer.sample(
        copy.deepcopy(rng), min(port_agent.config.batch_size,
                                port_agent.buffer.size))
    at_port = _jax_params(jax_before[0], {
        f"{part}::{n.replace('.', '/')}": p.detach().numpy()
        for part, net in nets.items() for n, p in net.named_parameters()})
    grad64 = {"float64": _grad64(nets, port_agent, batch),
              "jax_float64": _jax_grad64(jax_agent, *jax_before, batch),
              "jax_float64_at_port": _jax_grad64(jax_agent, at_port,
                                                 jax_before[1], batch)}
    for e in entries:
        for k, g in grad64.items():
            e["grad"][k] = float(g[e["param"]][tuple(e["index"])])
    return entries


def _grad64(nets, agent, batch) -> dict:
    """The gradient of the port's loss at the networks ``nets`` on
    ``batch``, in float64."""
    nets = {k: copy.deepcopy(v).double() for k, v in nets.items()}
    batch = tuple(torch.from_numpy(np.asarray(b, np.float64))
                  for b in batch)
    total, _ = loss_terms(nets["encoder"], nets["forward"],
                          nets["backward"], nets["target_encoder"], batch,
                          agent.config)
    total.backward()
    return {f"{part}::{n.replace('.', '/')}": (
        np.zeros(tuple(p.shape)) if p.grad is None else p.grad.numpy())
        for part in LEARNED for n, p in nets[part].named_parameters()}


def _jax_params(template, flat: dict):
    """JAX's ``FBParams`` shaped like ``template`` from flattened
    parameters (another side's)."""
    from raytracer_tpu.utils.checkpoint import _unflatten_like
    return type(template)(**{
        part: _unflatten_like(getattr(template, part), flat, part + "::")
        for part in PARTS})


def _jax_grad64(agent, params, opt_state, batch) -> dict:
    """The gradient of JAX's update at ``params`` on ``batch`` in float64:
    its jitted update step run in 64-bit mode on float64 copies, read off
    Adam's first moment."""
    import jax.numpy as jnp
    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64)
            if jnp.issubdtype(x.dtype, jnp.floating) else x,
            (params, opt_state))
        _, new, _, _ = agent._update_step(
            *wide, tuple(jnp.asarray(b, jnp.float64) for b in batch))
        old, = (s for s in wide[1] if hasattr(s, "mu"))
        adam, = (s for s in new if hasattr(s, "mu"))
        return {f"{part}::{k}": (np.asarray(m1) - 0.9 * np.asarray(m0)) / 0.1
                for part, t1, t0 in zip(LEARNED, adam.mu, old.mu)
                for (k, m1), m0 in zip(_flatten(t1).items(),
                                       _flatten(t0).values())}


def summarize(paths) -> None:
    """Print what the rows of one or more script runs (``--out`` files)
    show together: flag differences, agreement of counters and ring,
    each pair's median and largest ``param_rel_l2`` and guide gap, how
    often (e), a_eager and (b) part from (a) by over ``FACTOR`` times the
    ulp twins of (e), how often each reading fires and the ulp-twin
    reading on JAX against itself; then one markdown row a held scene."""
    runs = [json.loads(Path(p).read_text()) for p in paths]
    rows = [r for run in runs for r in run["rows"]]
    pairs = [f"{x}-{y}" for x, y in PAIRS]
    out = {"runs": [{k: run.get(k) for k in ("seed", "wrap_scene",
                                              "guided_rate", "seconds")}
                    for run in runs],
           "held": len(rows),
           "flag_diff": sum(r["compare"][p]["flag_diff"]
                            for r in rows for p in pairs),
           "counters_rng_equal": all(
               r["compare"][p]["counters"] and r["compare"][p]["rng"]
               for r in rows for p in pairs),
           "e_ring_equal": all(r["compare"]["e-a"]["ring_rel"] == 0
                               for r in rows),
           "records": [min(r["records"] for r in rows),
                       float(np.mean([r["records"] for r in rows])),
                       max(r["records"] for r in rows)],
           "updates": sorted({r["updates"] for r in rows})}
    for m in ("param_rel_l2", "guide_gap"):
        out[m] = {p: [float(np.median(v)), float(np.max(v))] for p in pairs
                  for v in [[r["compare"][p][m] for r in rows]]}

    def twins(c):
        return max(c["e_twin-e"]["param_rel_l2"],
                   c["e_down-e"]["param_rel_l2"])
    out["over_twins"] = {p: sum(r["compare"][p]["param_rel_l2"]
                                > FACTOR * twins(r["compare"]) for r in rows)
                         for p in ("e-a", "a_eager-a", "b-a")}
    out["fault"] = sum(bool(r["fault"]) for r in rows)
    out["ulp_reading"] = {p: sum(any(
        r["compare"][p][g] > FACTOR * r["compare"]["twin-c"][g]
        for g in ("param_gap", "guide_gap")) for r in rows)
        for p in ("c-a", "b-a", "a_eager-a")}
    print(json.dumps(out, indent=1))

    def f(x):
        return f"{x:.1e}" if x < 1e-3 else f"{x:.4f}"
    by = [{r["scene"]: r for r in run["rows"]} for run in runs]
    for g in sorted(set().union(*by)):
        cells = []
        for b in by:
            r = b.get(g)
            if r is None:
                cells.append("–")
                continue
            c, mark = r["compare"], "**" if r["fault"] else ""
            cells.append(f'{mark}{f(c["e-a"]["param_rel_l2"])}{mark}, '
                         f'{f(c["a_eager-a"]["param_rel_l2"])}, '
                         f'{f(twins(c))}')
        rs = [b[g] for b in by if g in b]
        print(f"| {g} ({rs[0]['guide_prob']}) | "
              + ", ".join(str(r["records"]) for r in rs) + " | "
              + str(sum(sum(c["flag_diff"] for c in r["compare"].values())
                        for r in rs)) + " | "
              + ("equal" if all(r["compare"]["e-a"]["ring_rel"] == 0
                                for r in rs) else "differs") + " | "
              + " | ".join(cells) + " | "
              + ", ".join("fires" if r["fault_ulp"] else "holds"
                          for r in rs) + " |")


class _Done(Exception):
    pass


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--summarize", nargs="+", default=None,
                   help="print what these --out files show together")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scenes", type=int, default=320)
    p.add_argument("--out")
    p.add_argument("--workdir")
    p.add_argument("--updates-at", type=int, default=None,
                   help="after this global scene, hold --update-steps "
                        "replay updates (hold_updates) and stop")
    p.add_argument("--update-steps", type=int, default=20)
    args = p.parse_args(argv)
    if args.summarize:
        return summarize(args.summarize)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(THREADS)
    from raytracer_tpu.fb.config import FBConfig as JaxConfig

    widths = dict(max_bounces=8, f_hidden_dim=512, b_hidden_dim=256)
    work = Path(args.workdir)
    jt = jax_trainer_mod.ChandelierOnlyTrainer(
        num_training_scenes=args.scenes, seed=args.seed,
        output_dir=work / "jax", guide_prob=0.0,
        config=JaxConfig(**widths))
    sides = {s: _port_trainer(FBConfig(**widths), args.seed, work, s)
             for s in ("c", "d", "twin", "e", "e_twin", "e_down")}
    snaps = SNAPSHOTS if args.updates_at is None else set()
    cap = jt.agent.buffer.capacity
    rows, state = [], {"g": 0, "wrap": None}
    train_on_scene = jt.train_on_scene

    def hooked(scene, name, episodes):
        g = state["g"]
        pre = jax_state(jt)
        with walks(jax_trainer_mod) as seen:
            rate = train_on_scene(scene, name, episodes)
        if state["wrap"] is None and jt.agent.buffer.size == cap:
            state["wrap"] = g
        if g == args.updates_at:
            Path(args.out).write_text(json.dumps(
                {"seed": args.seed, "updates_at": g,
                 "rows": hold_updates(jt, sides["e"], sides["e_twin"],
                                      args.update_steps)},
                indent=1, default=int))
            raise _Done
        if g in snaps or state["wrap"] in (g, g - 1):
            row = hold_scene(jt, sides, pre, seen[-1][0],
                             (scene, name, episodes), g)
            row["wrap_scene"] = state["wrap"]
            rows.append(row)
            c = row["compare"]
            print(json.dumps({
                "scene": g, "size": row["size"], "pos": row["pos"],
                "records": row["records"], "updates": row["updates"],
                "hits": row["hits"],
                "flag_diff": {k: v["flag_diff"] for k, v in c.items()},
                "param_gap": {k: v["param_gap"] for k, v in c.items()},
                "param_rel_l2": {k: v["param_rel_l2"]
                                 for k, v in c.items()},
                "param_gap_at": {k: v["param_gap_at"] for k, v in c.items()},
                "guide_gap": {k: v["guide_gap"] for k, v in c.items()},
                "fault": row["fault"], "fault_ulp": row["fault_ulp"],
                "seconds": round(row["seconds"], 1)}), flush=True)
            Path(args.out).write_text(json.dumps(
                {"seed": args.seed, "scenes": args.scenes, "rows": rows},
                indent=1, default=float))
        state["g"] += 1
        return rate

    jt.train_on_scene = hooked
    t0 = time.perf_counter()
    # scripts/ship_models.py::cmd_train_chandelier's chunk loop.
    chunks = [(args.scenes // 4, 0.0), (args.scenes // 4, 0.25),
              (args.scenes // 2, 0.5)]
    try:
        for n, gp in chunks:
            jt.guide_prob = gp
            jt.WALL_FRAC = 0.35
            jt.num_training_scenes = n
            jt.run_training(num_scenes=n, scenes_per_batch=20,
                            training_steps_per_scene=WALKERS)
    except _Done:
        return
    rates = [q["hit_rate"] for q in jt.all_performances]
    summary = {"seed": args.seed, "scenes": args.scenes,
               "wrap_scene": state["wrap"],
               "final_buffer_size": jt.agent.buffer.size,
               "guided_rate": float(np.mean(rates[len(rates) // 2:])),
               "seconds": time.perf_counter() - t0,
               "held": len(rows),
               "faults": [r["scene"] for r in rows if r["fault"]],
               "faults_ulp": [r["scene"] for r in rows
                              if r["fault_ulp"]]}
    Path(args.out).write_text(json.dumps(
        {**summary, "rows": rows, "hit_rates": rates}, indent=1,
        default=float))
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
