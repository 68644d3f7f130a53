#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It builds the
port's CUDA kernels with nvcc (all sources at once), then drives its
paths, each with the kernels' launch counts set to 0 just before and read
just after:

* the path tracer: the chandelier path-traced frame, 800x600, 8 spp, 8
  bounces, mirror_threshold=0.0, through ``render_path``;
* the Whitted tracer: planets2 at 2001x2001, 10 bounces, and marbles4 at
  801x801, 8 bounces, through ``render_whitted`` (the whole-trace Whitted
  kernel, and the shading kernel with its shadow sweeps inside, one launch
  a frame; phase whitted_shade times it on planets2's termini);
* the guided path tracer: the chandelier frame at 800x600, 8 spp, 8
  bounces, mirror_threshold=0.9, fb_prob=1.0, guided by the shipped
  distilled student (22->128->128->2, bf16), through ``render_path`` with
  impl="kernel" (the student inside the path kernel: a bf16 student on the
  tensor cores in csrc/path_guided.cu, an f32 one as scalar multiply-adds
  in csrc/path_trace.cu) and impl="hybrid" (the per-level kernel, the
  student between levels);
* the full FB agent as a guide (bench.py's full-agent cell): the chandelier
  at 200x100, 8 spp, 8 bounces, mirror_threshold=0.9, fb_prob=1.0, an
  agent at FBConfig()'s width (z 64, encoder 512, backward 256) with
  seeded weights, through ``render_path`` with impl="stepwise" (the
  nearest-hit kernel a level, the guide between levels; every level
  guided, and guide_max_level=3) and impl="hybrid" (the level kernel a
  level); phases fb_agent and fb_agent_times, then one 800x600@8spp/8
  frame with guide_max_level=3 (fb_agent_800x600); then the f32 guide's
  row kernel (csrc/guide_norm.cu) on one [160,000, 512] LayerNorm +
  residual site against its plain version and its byte bound, and the
  guide a call on a hybrid level's rows, fused and on the module path
  (guide_norm);
* the FB learner (the JAX CLI's train-fb-chandelier): ChandelierOnlyTrainer
  at its own config (full width), 12 scenes of 150 walkers and 12 more
  with the guide in the walk (guide_prob=0.25), through run_training: each
  scene's walk sweeps with the nearest-hit kernel, 8 launches, and the
  render probe runs the hybrid's level kernel (phase fb_train); then the
  agent it trained as an f32, bf16 and int8 guide through impl="hybrid" at
  the full-agent cell's shape (phase fb_guide_dtypes);
* the FB-vs-traditional comparison harness (the JAX CLI's
  compare-chandelier and compare-complex): chandelier_comparison with the
  shipped students at 200x100 and 800x600, 8 spp, 8 bounces, impl="kernel"
  on both sides (compare_student), complex_comparison with the shipped
  complex student (compare_complex), run_comparison with the agent
  fb_train trained through impl="hybrid" and "stepwise" (compare_agent),
  and spp_chunk=2 at 800x600 (compare_chunked);
* the distillation: distill_agent on that agent at its defaults, its
  observation walk the stepwise level (the nearest-hit kernel a level) and
  its shooting the nearest-hit kernel, then the student it makes through
  the guided kernel (phase distill);
* the output5 experiment: trace_output5's three methods at the fast_mode
  grid (the nearest-hit kernel a level), then CustomSceneExperiment end to
  end (the Whitted kernel for true_original; phase output5).
* the RL track at the shipped policies' configuration (the JAX CLI's
  rl-pipeline env: training_scene_complete at 400x300, fov 75, 8 bounces,
  2,048 episodes): the env through its kernel route (the Whitted kernel at
  reset, the nearest-hit kernel a level of each step, the shading kernel)
  against its plain route (phase rl_env); the shipped PPO and SAC
  through evaluate_policy and compare_rl_vs_random (rl_eval); PPO
  iterations at the shipped config and SAC updates on the card's ring
  buffer, the first updates held against float64 (rl_train); render_guided
  at 400x300@1spp, 5 bounces, three Whitted launches a bounce (rl_render).
* the frame-serving extras: README's planets2 turntable (24 frames,
  400x300, render_whitted_frames: the Whitted kernel and the shading
  kernel a frame; animate_whitted); the guided
  chandelier turntable (12 frames, 200x100@4spp/8, the registry's bf16
  student in the guided path kernel), the same unguided, and
  cornell_box:1007 at 160x120@4/8 with its student (animate_path);
  planets2 2001x2001@10 and marbles4 801x801@8 through
  render_whitted(impl="compact"), a nearest-hit launch a level on the live
  lanes (whitted_compact); the sharded renders on make_mesh() and on two
  shards of the one card (sharded); a reference-schema .pth at FBConfig()'s
  width through TrainedFBAgent against its .npz twin (pth_import); and the
  CLI's animate end to end (cli_animate).
* the rest of the RL track and the recipes: the shaped env
  (agents/adaptive.py) at the rl-pipeline env over 2,048 episodes with the
  shipped PPO's, uniform and light-seeking actions, kernel route against
  plain route, every reachable shaping term counted (rl_shaped);
  train_with_curriculum over dynamic_scene's phases at 800x600 with PPO
  and SAC, the parameter transfer bit for bit (rl_curriculum); the CLI's
  interactive menu, every option and mode, and its integration example
  (interactive); ship_models train-chandelier, distill --sharpen and eval,
  and ship_rl ppo-sweep, cut to size (ship_tools); and the flows that draw
  matplotlib figures, with or without matplotlib (figures).
* the training recipes: ship_models train-multi at the reference protocol
  (100 scenes x 150 walkers) and eval-multi of its teacher (100 held-out
  scenes x 256 episodes), uncut; train-complex, distill-ensemble and
  distill-episodes with their students' renders (the path kernels) and
  episode evaluations, and ship_rl ppo-ship and sac-ship (the Whitted and
  nearest-hit kernels through the env), cut to size (train_recipes); and
  each teacher trained in the run as a full guide on the chandelier at
  200x100@8spp/8, stepwise, against the traditional frame
  (teacher_renders).

It holds every kernel against its plain PyTorch version, checks frames
against the executed-reference goldens, holds the path and level kernels
against their plain versions on seeded scenes built to cross the shared
level's exact rewrites (phase level_edges) and the nearest-hit kernel on
seeded ray sets built to cross the sweep's (phase nearest_hit), times
everything on the card's clock (the nearest-hit kernel on planets2's
shadow sweep and on the stepwise path level's sweep of the chandelier's
29 spheres, phase nearest_hit_times) and prints JSON lines.  The last
line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before it.  Without a CUDA
device it exits 1 and prints no result.
"""
import contextlib
import copy
import io
import json
import os
import shutil
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from raytracer_tpu_torch import cli
from raytracer_tpu_torch.agents import SHIPPED_DIR
from raytracer_tpu_torch.agents.adaptive import (AdaptiveRewardRayTracerEnv,
                                                 train_with_curriculum)
from raytracer_tpu_torch.agents.ppo import (PPOConfig, PPOTrainer,
                                            clip_by_global_norm_)
from raytracer_tpu_torch.agents.sac import SACConfig, SACTrainer
from raytracer_tpu_torch.compare import rl_renderer
from raytracer_tpu_torch.compare.workbench import (compare_rl_vs_random,
                                                   evaluate_policy,
                                                   load_policy,
                                                   random_actions)
from raytracer_tpu_torch.core import (cuda_intersect, cuda_level, cuda_norm,
                                      cuda_path, cuda_shade, cuda_whitted,
                                      native, vec)
from raytracer_tpu_torch.env.raytracer_env import RayTracerEnv
from raytracer_tpu_torch.env.scenes import (dynamic_scene,
                                            training_scene_complete)
from raytracer_tpu_torch.compare.experiment import (CONFIG_MODES,
                                                    CustomSceneExperiment)
from raytracer_tpu_torch.compare.harness import (chandelier_comparison,
                                                 complex_comparison,
                                                 run_comparison, side_seeds)
from raytracer_tpu_torch.core.intersect import NO_SUPPRESS
from raytracer_tpu_torch.fb import distill, fused_guide, quantize
from raytracer_tpu_torch.fb import trajectory as fb_walk
from raytracer_tpu_torch.fb.agent import FBResearchAgent, loss_terms
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.distill import DistilledGuide, distill_agent
from raytracer_tpu_torch.fb.inference import (TrainedFBAgent,
                                              small_light_indices)
from raytracer_tpu_torch.fb.networks import Dense, LayerNorm
from raytracer_tpu_torch.fb.registry import (STUDENTS_DIR, guide_for,
                                             model_path_for)
from raytracer_tpu_torch.fb.trainer import ChandelierOnlyTrainer
from raytracer_tpu_torch.parallel import mesh as pmesh
from raytracer_tpu_torch.render import animation
from raytracer_tpu_torch.scene.templates import generate_scene
from raytracer_tpu_torch.utils.checkpoint import PARTS, load_fb, save_fb
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.profiling import device_trace
from raytracer_tpu_torch.render.camera import grid_rays, perspective_rays
from raytracer_tpu_torch.render import path_renderer
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.render.renderer import material_flags, render_whitted
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.scene.complex import (create_camera_for_scene,
                                               create_complex_scene)
from raytracer_tpu_torch.scene.library import chandelier_scene
from raytracer_tpu_torch.tools import (level_edges, ship_models, ship_rl,
                                       sweep_edges)
from raytracer_tpu_torch.tools.shaping_edges import (
    TERMS as SHAPING_TERMS, light_seeking_actions, shaping_terms)
from raytracer_tpu_torch.trace.path import (emissive_indices, scene_spec,
                                            trace_path)
from raytracer_tpu_torch.trace.output5_style import METHODS as O5_METHODS
from raytracer_tpu_torch.trace.output5_style import draw_planes, trace_output5
from raytracer_tpu_torch.trace.whitted import trace_whitted

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "showcase" / "parity_fullres" / "chandelier_800x600_ref.npy"
WHITTED_GOLDEN = (ROOT / "showcase" / "parity_fullres" /
                  "true_original_601_ref.npy")
SOURCES = ("path_trace", "path_guided", "whitted_trace", "nearest_hit",
           "path_level", "guide_norm", "whitted_shade")
SEED = 0
W, H, SPP, BOUNCES = 800, 600, 8, 8
BG = (2.0, 2.0, 5.0)

# H100 SXM rates.  f32 operations outside the tensor cores, none fused:
# every kernel is built with -fmad=false (core/native.py), so an add or a
# multiply is one instruction on one lane, 132 SMs x 128 lanes x 1.98 GHz =
# 33.5 T operations/s; the data sheet's 67 TFLOP/s counts each fused
# multiply-add as two operations.  HBM3 bandwidth from the data sheet.
PEAK_F32_OPS = 33.5e12
PEAK_BYTES = 3.35e12
# f32 operations of the path level (csrc/path_common.cuh), counted from its
# code, each IEEE square root or divide as one: what the function needs on
# the run's data (tools/level_edges.py::level_work counts it level by
# level), a valid sphere's thc and t and a light term's weight only where
# they can change an output.  The sweep: l, tca and its test a sphere test;
# d2 and its test a test in front of the ray; r^2, thc, t, |t| and the
# nearest test a valid test.  Direct light: t, d2, t.n and the cull test a
# light term of a continuing level; the square root, three divides, cos,
# the weight, trunc and sum a term not skipped.  A continuing level: the hit
# point, normal, offset and fold, and the mirror reflection where it is
# kept (a diffuse lane's bounce is not counted).  The first normalisation a
# ray.  The plain version computes every term: 26 a sphere test, 32 a light
# term and 82 a continuing level (OPS_PLAIN_*).
OPS_SPHERE = 9
OPS_SPHERE_FRONT = 9
OPS_SPHERE_VALID = 7
OPS_LIGHT = 14
OPS_LIGHT_COMPUTED = 24
OPS_CONTINUE = 40
OPS_REFLECT = 42
OPS_PER_RAY = 10
OPS_PLAIN_SPHERE, OPS_PLAIN_LIGHT, OPS_PLAIN_CONTINUE = 26, 32, 82
BYTES_PER_RAY = 24 + 12 + 16     # origin + direction in; rgb + counts out
# f32 operations of csrc/whitted_trace.cu and csrc/nearest_hit.cu, counted
# from their code (whitted_trace.cu helpers): the sweep (csrc/sphere.cuh::
# test) as the path level's, OPS_SPHERE, OPS_SPHERE_FRONT and
# OPS_SPHERE_VALID on the tests, the tests in front of the ray and the valid
# ones of the run's data (core/cuda_intersect.py::sweep_work), and every
# term of it, 26 a sphere test, as the plain version computes it
# (W_OPS_SWEEP_PER_SPHERE, reported beside); per level run, the hit point,
# normal and budget test; a mirror bounce (reflect3); a glass entry
# (refract3 in and a far-root exit); per walk step the outward refract3,
# and per internal reflection a reflect3 and a far-root exit; the first
# normalisation.
W_OPS_SWEEP_PER_SPHERE = 26
W_OPS_LEVEL = 20
W_OPS_MIRROR = 42
W_OPS_GLASS_ENTRY = 98
W_OPS_WALK_STEP = 61
W_OPS_WALK_REFLECT = 82
W_OPS_PER_RAY = 10
W_BYTES_IN, W_BYTES_SUPPRESS, W_BYTES_OUT = 24, 4, 1 + 4 + 4 + 12 + 12 + 4 + 4
NH_BYTES_OUT = 4 + 4 + 1          # t, idx, found
# f32 operations of csrc/whitted_shade.cu, counted from its code, each IEEE
# square root or divide as one and acosf as 12 (its reduction and
# polynomial): a hit terminus's emission, |n| and rounding; a global light's
# dot, norm, cosine, clamp, acos, falloff, strength and sum; a point light's
# vector, id test and sum at every hit terminus; a swept shadow ray's norm,
# clamp, three divides, glass rule and terminus test, its sweep counted as
# the nearest-hit kernel's (OPS_SPHERE*); a lit one's dot, cosine, clamp,
# acos, falloff and strength, and the distance divide where func is 0.
# Bytes: hit in and RGB out a terminus; idx, point and normal in a hit.
S_OPS_TERMINUS = 21
S_OPS_GLOBAL = 37
S_OPS_POINT = 10
S_OPS_SWEPT = 13
S_OPS_LIT = 25
S_BYTES_RAY, S_BYTES_HIT = 1 + 12, 4 + 12 + 12
# nearest_hit: seeded ray sets on the edges of the sweep's rewrites
# (raytracer_tpu_torch/tools/sweep_edges.py), rays a set; the seed of the
# stepwise level's camera rays (case b).
NH_EDGE_SEEDS = (SEED + 30, SEED + 31)
NH_EDGE_RAYS = 200_000
NH_LEVEL_SEED = SEED + 14
# Fallback bounds of the Whitted kernel, the JAX package's own for its TPU
# kernel (tests/test_pallas_whitted.py:28-49): discrete fields exact, floats
# within rtol/atol 2e-4, at most 0.1% of pixels off by more than 1/255.
W_RTOL = W_ATOL = 2e-4
W_PIXELS_OFF = 1e-3
# Guided path tracer (bench.py's guided cell): the student's width, the fb
# gate, and the bounds the JAX package holds its guided TPU kernel to for a
# dense student (tests/test_pallas_path.py:149-181): at least 90% of samples
# equal, light hits within 0.9-1.12x.
G_THRESHOLD = 0.9
G_FB_PROB = 1.0
G_WIDTH = 128
G_MIN_EQUAL = 0.9
G_HITS = (0.9, 1.12)
# Published H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet): the
# least time for the student's flops.
PEAK_BF16 = 989e12
STUDENT_FLOPS = 2 * (22 * 128 + 128 * 128 + 128 * 2)   # a guided ray-level
# Bytes of the guided kernel beyond the unguided one: six counts out, not
# four; the fb uniform of every guided ray-level in (at fb_prob=1 every
# diffuse ray-level is guided and reads no cosine uniforms).
G_BYTES_PER_RAY = 24 + 12 + 24
G_BYTES_FB = 4
# Bytes of csrc/path_level.cu a ray-level: o, d and running in; state, rec,
# o_next, d_next and the hit plane out; the uniforms of a diffuse lane in.
LVL_BYTES_PER_RAY = 12 + 12 + 1 + 1 + 24 + 12 + 12
LVL_BYTES_HIT = 44
LVL_BYTES_U = 8
# The full FB agent (bench.py's full-agent cell, bench.py:108-170): frame,
# the stepwise deployment knob (raytracer_tpu/trace/path.py:200-207) and
# the larger frame run once.  The guide's products run as cuBLAS SGEMM in
# full f32, bounded by the data sheet's 67 TFLOP/s f32 rate (a fused
# multiply-add counted as two operations).
A_W, A_H = 200, 100
A_GML = 3
A_BIG_W, A_BIG_H = 800, 600
PEAK_F32_FLOPS = 67e12
# The f32 guide's row kernel (csrc/guide_norm.cu): one site of a residual
# block's second layer (LayerNorm, + residual) over a guided level's rows at
# the encoder's width; it reads y and the residual and writes y.
GN_ROWS, GN_WIDTH = A_W * A_H * SPP, 512
GN_BYTES = 3 * GN_ROWS * GN_WIDTH * 4
# Its launches a guide call (fb/fused_guide.py), and the kinds of site the
# FBConfig() guide holds at each width: (LayerNorm?, post, width).
GN_SITES = 16
GN_KINDS = {("ln", "relu", 512), ("ln", "residual", 512),
            ("ln", "relu", 256), ("ln", "residual", 256),
            ("bias", None, 512), ("bias", "relu", 512),
            ("bias", "residual", 512), ("bias", None, 128)}
# The FB learner (ChandelierOnlyTrainer at its own config, full width):
# scenes without the guide in the walk, then with guide_prob 0.25, walkers
# a scene (the JAX CLI's training steps a scene, raytracer_tpu/cli.py:246),
# the held-out test's rays.  One update step (update_card_vs_cpu): the loss
# terms card vs CPU within the CPU tests' 1e-5 (tests/test_torch_fb_learner
# .py); each float32 gradient, leaf by leaf, within T_GRAD_TOL of its
# leaf's largest of the float64 gradient taken through the same ReLU and
# clamp branches, and each ReLU and clamp input within T_ACT_TOL of its
# site's largest of float64's; the card's Adam step within one float32 ulp
# of the parameter (plus 1e-6 lr) of the same step in float64 from the
# card's gradient.  The int8 guide against its CPU twin: rows whose int8
# activations are the same on both devices within float rounding
# (INT8_SAME_LEVELS), the others within the CPU tests' INT8_MAX
# (tests/test_torch_fb_quantize.py).  The bf16 and int8 guides against f32
# on a frame's guided rows: JAX's own int8 bounds (tests/test_quantize.py:
# 38-50, on 256 rows), but the int8 largest at 0.17: on this frame's rows
# the int8 scheme itself passes 0.15, JAX's own int8 guide by 0.164 and
# the port's by 0.165 (tests/int8_rows_vs_jax.py on the rows this phase
# saves).  The int8 tensor-core peak (NVIDIA data sheet, dense).
T_SCENES, T_GUIDED_SCENES, T_WALKERS = 12, 12, 150
T_GUIDE_PROB = 0.25
T_HELD_OUT = 200
T_LOSS_TOL = T_GRAD_TOL = T_ACT_TOL = 1e-5
T_STEP_ULPS, T_STEP_LR = 1.0, 1e-6
INT8_MAX = 0.05
INT8_SAME_LEVELS = 1e-5
DTYPE_BOUNDS = {"bfloat16": dict(max=0.15, mean=0.03),
                "int8": dict(max=0.17, mean=0.03)}
PEAK_INT8 = 1979e12
# The comparison harness, the distillation and the output5 experiment: the
# reference comparison's frame (FB/fb_vs_traditional_chandelier.py, the JAX
# CLI's compare-chandelier defaults) and the deployment frame (W x H); the
# harness's best-of timed renders; the chunk of compare_chunked (the CLI's
# --spp-chunk); the counts held against plain; the experiment's mode.
C_W, C_H = 200, 100
C_ITERS = 3
C_CHUNK = 2
C_COUNTS = ("total_rays", "total_intersections", "light_hits",
            "small_light_hits")
O5_MODE = "fast_mode"
# The RL track at the shipped policies' configuration (the JAX CLI's
# rl-pipeline env, raytracer_tpu/cli.py:466-469): training_scene_complete
# at 400x300, fov 75, 8 bounces, variant "rl", 2,048 episodes of
# max_bounces + 2 steps; PPO at the shipped __config__ (128x128, 512
# envs, ent_coef 0.01), SAC at 256x256, 128 envs, batch 256.  The shipped
# light-hit rates, the TPU's evaluation at 2,048 episodes
# (models/ppo_raytracer_benchmark.json; models/ is not on the card's
# copy), each held to 4 binomial standard deviations at 2,048 episodes; the
# shipped SAC to the JAX package's own pin (tests/test_trained_models.py:
# its light hits above random's x 1.05, its reward above random's x 1.5).
# The renderer at its defaults, 400x300@1spp, 5 bounces.
RL_W, RL_H, RL_FOV, RL_BOUNCES, RL_EPISODES = 400, 300, 75, 8, 2048
RL_PPO_HITS, RL_RANDOM_HITS = 0.14404296875, 0.0966796875
RL_SIGMAS = 4.0
RL_PPO_ITERS, RL_SAC_ITERS, RL_SAC_UPDATES = 3, 4, 64
RL_RENDER_BOUNCES = 5
# The rest of the RL track and the recipes.  rl_shaped: the shaped env at
# ppo_train_to_win's env (the rl-pipeline env above), its light ids 99 and
# 100.  rl_curriculum: the JAX CLI's interactive mode 2 envs
# (dynamic_scene phases 1-3 at 800x600, fov 90, 5 bounces), CUR_STEPS a
# phase.  ship_tools: train-chandelier cut from 160 scenes of 200 steps to
# ST_SCENES of ST_STEPS in the same three chunks, the student distilled
# from it at ST_FRAMES frames and ST_EPOCHS epochs, and ppo-sweep at
# --scale ST_SWEEP_SCALE (the script's --quick scales by 0.25 whatever
# --scale says).
CUR_W, CUR_H, CUR_FOV, CUR_BOUNCES, CUR_STEPS = 800, 600, 90, 5, 5200
IT_STEPS = 256
ST_SCENES, ST_STEPS, ST_FRAMES, ST_EPOCHS = 8, 50, 2, 10
ST_SWEEP_SCALE = 0.02
# The training recipes (train_recipes).  train-multi at the reference
# protocol, uncut (100 scenes cycling the 8 templates, 150 walkers a
# scene, FBConfig()), then eval-multi of its teacher at its defaults,
# uncut (100 held-out scenes x 256 episodes, seed 0), beside JAX's recorded
# result (models/fb_multi_scene_held_out.json, its round-3 generalist:
# policy 0.017578125, random 0.0103125; models/ is not on the card's
# copy).  Cut: train-complex from 160 scenes x 200 walkers to TR_COMPLEX;
# distill-ensemble from 6 frames and 40 epochs to TR_DISTILL; the
# students' eval-multi from 100 scenes to TR_STUDENT_SCENES;
# distill-episodes from 24 scenes x 8,192 walkers and 40 epochs to
# TR_EPISODES; ppo-ship's stages (0.4M/0.6M/1M steps) by TR_PPO_SCALE, its
# evaluation from 2,048 episodes to TR_RL_EVAL and its CPU probe from
# 100,000 steps to TR_RL_CPU_PROBE; sac-ship from 400,000 nominal steps to
# TR_SAC_STEPS, the same evaluation and probe cuts.
TR_MULTI = (100, 150)
TR_EVAL = (100, 256)
JAX_MULTI_HELD_OUT = {"policy_hit_rate": 0.017578125,
                      "random_hit_rate": 0.0103125,
                      "ratio": 1.7045454545454544}
TR_COMPLEX = (24, 100)
TR_DISTILL = (2, 10)
TR_STUDENT_SCENES = 16
TR_EPISODES = (4, 2048, 10)
TR_PPO_SCALE = 0.02
TR_SAC_STEPS = 20_000
TR_RL_EVAL, TR_RL_CPU_PROBE = 512, 4096
# teacher_renders: the route on which a trained teacher's light hits are
# read (PERF.md §6): ship_models eval at 200x100@8spp/8, seed 5, stepwise
# on both sides; the traditional frame's small-light hits on it, as every
# recorded render of this route on the H100 gave them.
TEACHER_FRAME, TEACHER_SEED = (200, 100, 8), 5
TEACHER_TRADITIONAL_HITS = 895

# level_edges: seeded scenes on the edges of the level's exact rewrites
# (raytracer_tpu_torch/tools/level_edges.py), rays a scene.
EDGE_SEEDS = (SEED + 20, SEED + 21, SEED + 22)
EDGE_RAYS = 200_000


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card's clock (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops, nbytes):
    """Least time for ``ops`` f32 operations and ``nbytes`` bytes: the
    larger of the two over the card's peaks, and which one sets it."""
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def add_work(total, work):
    """Sums ``level_work`` dicts into ``total``, nested ones flattened."""
    for k, v in work.items():
        for kk, vv in (v.items() if isinstance(v, dict) else ((None, v),)):
            key = k if kk is None else f"{k}_{kk}"
            total[key] = total.get(key, 0) + vv
    return total


def level_ops(work):
    """``(f32 operations the level needs, those the plain version does)``
    over summed ``level_work`` counts."""
    ops = (OPS_SPHERE * work["sphere_tests"]
           + OPS_SPHERE_FRONT * work["front_sphere_tests"]
           + OPS_SPHERE_VALID * work["valid_sphere_tests"]
           + OPS_LIGHT * work["light_terms"]
           + OPS_LIGHT_COMPUTED * work["lights_computed"]
           + OPS_CONTINUE * work["continuing"]
           + OPS_REFLECT * work["reflections"])
    plain = (OPS_PLAIN_SPHERE * work["sphere_tests"]
             + OPS_PLAIN_LIGHT * work["light_terms"]
             + OPS_PLAIN_CONTINUE * work["continuing"])
    return ops, plain


def traced_work(o, d, u, table, **kw):
    """``(rgb, counts, summed level_work)`` of ``path_trace_plain`` on these
    inputs: the plain trace, each level's work counted on its data."""
    total = {}

    def counted(lo, ld, lrun, lu, ltable, **lkw):
        lv = cuda_path.level_plain(lo, ld, lrun, lu, ltable,
                                   fast=lkw["fast"], want_hit=True)
        add_work(total, level_edges.level_work(lo, ld, lrun, lu, ltable, lv))
        return lv

    # path_trace_plain is trace_levels over level_plain.
    rgb, counts = cuda_path.trace_levels(counted, o, d, u, table, **kw)
    return rgb, counts, total


def sweep_ops(work):
    """``(f32 operations the sweep needs, every term of it)`` over
    ``cuda_intersect.sweep_work`` counts."""
    ops = (OPS_SPHERE * work["sphere_tests"]
           + OPS_SPHERE_FRONT * work["front_sphere_tests"]
           + OPS_SPHERE_VALID * work["valid_sphere_tests"])
    return ops, W_OPS_SWEEP_PER_SPHERE * work["sphere_tests"]


def whitted_rest_ops(work, rays):
    """f32 operations of the Whitted kernel beyond its sweeps, over
    ``whitted_trace_plain``'s ``counters``."""
    return (W_OPS_PER_RAY * rays + W_OPS_LEVEL * work["levels"]
            + W_OPS_MIRROR * work["mirror"]
            + W_OPS_GLASS_ENTRY * work["glass"]
            + W_OPS_WALK_STEP * work["walk_steps"]
            + W_OPS_WALK_REFLECT * (work["walk_steps"] - work["walk_exits"]))


def nearest_hit_modes(o, d, sup, table):
    """The nearest-hit kernel against its plain version on these rays in
    the four modes (signed t or |t|, exact or fast test): ``(bit_equal,
    max |t diff| where both found a hit)``."""
    equal, err = True, 0.0
    for by_abs in (False, True):
        for fast in (False, True):
            a = cuda_intersect.nearest_hit(o, d, sup, table, by_abs=by_abs,
                                           fast=fast)
            b = cuda_intersect.nearest_hit_plain(o, d, sup, table,
                                                 by_abs=by_abs, fast=fast)
            equal &= all(bool(torch.equal(x, y)) for x, y in zip(a, b))
            both = a[2] & b[2]
            err = max(err, float((a[0] - b[0]).abs().where(both, 0.0).max()))
    return equal, err


def stats_close(a, b, rel):
    return all(abs(a[k] - b[k]) <= rel * max(abs(b[k]), 1) for k in b)


def reset_counts():
    """Every kernel's launch count to 0."""
    cuda_path.path_trace.launches = 0
    for route in cuda_path.path_trace.route_launches:
        cuda_path.path_trace.route_launches[route] = 0
    cuda_whitted.whitted_trace.launches = 0
    cuda_intersect.nearest_hit.launches = 0
    cuda_level.path_level.launches = 0
    cuda_norm.guide_norm.launches = 0
    cuda_shade.whitted_shade.launches = 0


def read_counts():
    return {"path_trace": cuda_path.path_trace.launches,
            "whitted_trace": cuda_whitted.whitted_trace.launches,
            "nearest_hit": cuda_intersect.nearest_hit.launches,
            "whitted_shade": cuda_shade.whitted_shade.launches}


def shade_work(scene, gl, pl, res, table):
    """The work of csrc/whitted_shade.cu on these termini: ``(f32
    operations, bytes, counts)``, the shadow rays' sweeps counted on their
    data (``cuda_intersect.sweep_work``) and the lit terms from the plain
    sweep."""
    hit = res.hit
    hits = int(hit.sum())
    self_id = table.ids[res.idx]
    counts = {"termini": hit.shape[0], "hits": hits, "swept": 0, "lit": 0,
              "lit_func0": 0}
    sweep = {}
    px, py, pz = res.point.unbind(1)
    for k, (lid, func) in enumerate(zip(pl.id.tolist(), pl.func.tolist())):
        active = hit & (self_id != lid)
        dirs = torch.stack(vec.normalise_safe_c(
            pl.position[k, 0] - px, pl.position[k, 1] - py,
            pl.position[k, 2] - pz), 1)
        add_work(sweep, cuda_intersect.sweep_work(res.point, dirs, self_id,
                                                  table, active=active))
        _, idx, found = cuda_intersect.nearest_hit_plain(res.point, dirs,
                                                         self_id, table)
        glass = (scene.transparent[idx] == 1.0) & (scene.reflective[idx]
                                                   != 1.0)
        n_lit = int((active & found & ~glass & (table.ids[idx] == lid))
                    .sum())
        counts["swept"] += int(active.sum())
        counts["lit"] += n_lit
        counts["lit_func0"] += n_lit if func == 0 else 0
    ops = (hits * (S_OPS_TERMINUS + S_OPS_GLOBAL * gl.count
                   + S_OPS_POINT * pl.count)
           + S_OPS_SWEPT * counts["swept"]
           + (sweep_ops(sweep)[0] if sweep else 0)
           + S_OPS_LIT * counts["lit"] + counts["lit_func0"])
    nbytes = S_BYTES_RAY * counts["termini"] + S_BYTES_HIT * hits
    return ops, nbytes, {**counts, **sweep}


def bits_equal(a, b):
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def shade_entry(name, calls):
    """A ``kernels`` entry for the shading-kernel launches ``calls`` (as
    ``recorded_launches`` returns them), replayed: each output against
    the plain shading on the same arguments bit for bit, device ms queued
    behind a spin kernel, the plain version's ms, the bound from the work
    on these termini."""
    def replay(fn=None):
        for args, kw, _ in calls:
            (fn or cuda_shade.whitted_shade)(*args, **kw)

    equal = all(bits_equal(out, cuda_shade.whitted_shade_plain(*args, **kw))
                for args, kw, out in calls)
    dev_ms = queued_ms(replay)
    plain_ms = cuda_ms(lambda: replay(cuda_shade.whitted_shade_plain), 2)
    ops = nbytes = 0
    work = {}
    for (scene, gl, pl, res, _, _, table), kw, _ in calls:
        o, b, w = shade_work(scene, gl, pl, res, table
                             or cuda_intersect.sphere_table(scene))
        ops, nbytes = ops + o, nbytes + b
        add_work(work, w)
    b_ms, b_by = bound(ops, nbytes)
    return {"name": name, "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/whitted_shade.cu",
            "replaces": None,
            "replaces_note": "no pallas_call: raytracer_tpu/trace/shade.py::"
                             "terminal_rgb (plain jnp) and its "
                             "nearest_hit_pallas shadow sweeps",
            "launches_timed": len(calls), "bit_equal": equal,
            "max_abs_err": 0.0 if equal else None, "ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / dev_ms if dev_ms > 0 else None,
            "bound_ops": ops, "bound_bytes": nbytes, "work": work,
            "library_ms": None}


def notebook_frame(name, multiple, dev):
    """A library scene and its grid camera at ``multiple`` (host ms of the
    camera, which builds float64 numpy on the host, beside it)."""
    scene, gl, pl, p = getattr(library, name + "_scene")(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o, d, h, w = grid_rays(p["ray_count"], p["ray_step"], multiple,
                           origin=p["camera_position"], device=dev)
    torch.cuda.synchronize()
    camera_ms = (time.perf_counter() - t0) * 1e3
    kw = dict(max_bounces=p["max_bounces"], background=p["background"],
              miss_colour=p.get("sky_colour"))
    return scene, gl, pl, o, d, h, w, kw, camera_ms


def compare_traces(a, b):
    """``(bit_equal, max |float diff|, within the fallback bound)``."""
    discrete = all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("hit", "idx", "bounces", "through"))
    floats = ("t", "point", "normal")
    err = max(float((getattr(a, f) - getattr(b, f)).abs().max())
              for f in floats)
    close = all(torch.allclose(getattr(a, f), getattr(b, f), rtol=W_RTOL,
                               atol=W_ATOL) for f in floats)
    return discrete and err == 0.0, err, discrete and close


def compare_images(a, b):
    """``(bit_equal, max |diff|, share of pixels off by more than 1/255)``."""
    diff = (a - b).abs()
    off = float((diff.amax(-1) > 1 / 255 + 1e-7).float().mean())
    return bool(torch.equal(a, b)), float(diff.max()), off


def whitted_phases(dev, card):
    """The Whitted path's phases; returns its two ``kernels`` entries and
    the shading kernel's."""
    # whitted_main: planets2 2001x2001@10 and marbles4 801x801@8 through
    # render_whitted, kernel then plain.
    main = {}
    for name, multiple in (("planets2", 10), ("marbles4", 4)):
        t0 = time.perf_counter()
        scene, gl, pl, o, d, h, w, kw, camera_ms = notebook_frame(
            name, multiple, dev)
        reset_counts()
        img_k = render_whitted(scene, gl, pl, o, d, h, w, impl="kernel", **kw)
        torch.cuda.synchronize()
        launches = read_counts()
        check(launches["whitted_trace"] >= 1,
              f"{name}: render_whitted launched no whitted_trace kernel")
        check(launches["whitted_shade"] == 1 and launches["nearest_hit"] == 0,
              f"{name}: the shading is not one whitted_shade launch with "
              f"its sweeps inside: {launches}")
        img_p = render_whitted(scene, gl, pl, o, d, h, w, impl="plain", **kw)
        torch.cuda.synchronize()
        check(tuple(img_k.shape) == (h, w, 3), f"image shape {img_k.shape}")
        check(bool(torch.isfinite(img_k).all()), "non-finite pixels")
        check(float(img_k.min()) >= 0.0 and float(img_k.max()) <= 1.0,
              "pixels outside [0, 1]")
        img_equal, img_err, img_off = compare_images(img_k, img_p)
        eg, em = material_flags(scene)
        tkw = dict(enable_glass=eg, enable_mirror=em)
        res_k = trace_whitted(scene, o, d, kw["max_bounces"], impl="kernel",
                              **tkw)
        res_p = trace_whitted(scene, o, d, kw["max_bounces"], impl="plain",
                              **tkw)
        tr_equal, tr_err, tr_close = compare_traces(res_k, res_p)
        hit_frac = float(res_k.hit.float().mean())
        emit({"phase": "whitted_main", "scene": name,
              "frame": f"{w}x{h}/{kw['max_bounces']}", "rays": h * w,
              "launches": launches, "image_bit_equal": img_equal,
              "image_max_abs_err": img_err, "pixels_off_fraction": img_off,
              "trace_bit_equal": tr_equal, "trace_max_abs_err": tr_err,
              "hit_fraction": hit_frac,
              "max_through": int(res_k.through.max()),
              "max_bounces_reached": int(res_k.bounces.max()),
              "grid_rays_ms": camera_ms,
              "seconds": time.perf_counter() - t0})
        check(0.0 < hit_frac <= 1.0, f"{name}: no ray hit anything")
        check((img_equal or img_off <= W_PIXELS_OFF)
              and (tr_equal or tr_close),
              f"{name}: kernel vs plain: image {img_err} max, {img_off} of "
              f"pixels off; trace {tr_err} max")
        main[name] = dict(scene=scene, gl=gl, pl=pl, o=o, d=d, h=h, w=w,
                          kw=kw, tkw=tkw, launches=launches, img_p=img_p,
                          res_k=res_k, err=tr_err, camera_ms=camera_ms)
    whitted_err = max(m["err"] for m in main.values())

    # whitted_golden: true_original 601x601@5 through the kernel against
    # the executed reference.
    t0 = time.perf_counter()
    scene, gl, pl, o, d, h, w, kw, _ = notebook_frame("true_original", 3,
                                                      dev)
    img = render_whitted(scene, gl, pl, o, d, h, w, impl="kernel", **kw)
    img = img.cpu().numpy().astype(np.float64)
    ref = np.load(WHITTED_GOLDEN).astype(np.float64)
    dd = np.abs(img - ref)
    agree = dd.max(axis=-1) <= 1 / 255
    divergent = int((~agree).sum())
    mse_agree = float(np.mean(dd[agree] ** 2))
    emit({"phase": "whitted_golden", "frame": f"{w}x{h}/5",
          "divergent_pixels": divergent, "mse_agreeing": mse_agree,
          "exact_pixel_fraction": float((dd.max(-1) == 0).mean()),
          "bounds": {"divergent_pixels": "<= 32", "mse_agreeing": "< 1e-8"},
          "seconds": time.perf_counter() - t0})
    check(divergent <= 32 and mse_agree < 1e-8,
          f"whitted golden: {divergent} divergent pixels, mse {mse_agree}")

    # nearest_hit: kernel vs plain in the four modes on planets2's primary
    # rays and a ragged 3601-ray set (ids suppressed on every third ray), on
    # seeded ray sets built to cross the sweep's rewrites (tools/
    # sweep_edges.py; every edge must be crossed) and on the stepwise
    # level's chandelier camera rays (case b); then a planets2 frame with
    # every level's sweep through the kernel.
    t0 = time.perf_counter()
    m = main["planets2"]
    scene = m["scene"]
    table = cuda_intersect.sphere_table(scene, **m["tkw"])
    n_sph = len(table.spec)
    dn = torch.nn.functional.normalize(m["d"], dim=1).contiguous()
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    o_r = (torch.rand((3601, 3), device=dev, generator=gen) * 6 - 3)
    d_r = torch.nn.functional.normalize(
        torch.randn((3601, 3), device=dev, generator=gen), dim=1)
    sets = {}
    for name, o_s, d_s in (("planets2_primary", m["o"], dn),
                           ("ragged_3601", o_r.contiguous(),
                            d_r.contiguous())):
        i = torch.arange(o_s.shape[0], device=dev)
        sup = torch.where(i % 3 == 0, table.ids[(i // 3) % n_sph],
                          NO_SUPPRESS).to(torch.int32)
        sets[name] = (o_s, d_s, sup, table)
    edges = {}
    for seed in NH_EDGE_SEEDS:
        e_table, e_o, e_d, e_sup = sweep_edges.edge_case(seed, NH_EDGE_RAYS,
                                                         dev)
        sets[f"edges_{seed}"] = (e_o, e_d, e_sup, e_table)
        edges[f"edges_{seed}"] = sweep_edges.edge_counts(e_o, e_d, e_sup,
                                                         e_table)
    l_table, l_o, l_d = sweep_edges.level_rays(dev, NH_LEVEL_SEED)
    sets["chandelier_level"] = (l_o, l_d, None, l_table)
    edges["chandelier_level"] = sweep_edges.edge_counts(l_o, l_d, None,
                                                        l_table)
    nh_err, nh_equal, per_set = 0.0, True, {}
    for name, (o_s, d_s, sup, tab) in sets.items():
        eq, err = nearest_hit_modes(o_s, d_s, sup, tab)
        per_set[name] = {"rays": o_s.shape[0], "bit_equal": eq,
                         "max_abs_err": err}
        nh_equal &= eq
        nh_err = max(nh_err, err)
    img_s = render_whitted(scene, m["gl"], m["pl"], m["o"], m["d"], m["h"],
                           m["w"], impl="plain", sweep="kernel", **m["kw"])
    sweep_equal = bool(torch.equal(img_s, m["img_p"]))
    crossed = all(v > 0 for k, v in edges.items() if k.startswith("edges_")
                  for v in v.values())
    emit({"phase": "nearest_hit", "sets": per_set,
          "bit_equal": nh_equal, "max_abs_err": nh_err,
          "edge_counts": edges, "every_edge_crossed": crossed,
          "sweep_kernel_frame_bit_equal": sweep_equal,
          "seconds": time.perf_counter() - t0})
    check(nh_equal, f"nearest_hit kernel vs plain differ ({per_set})")
    check(crossed, f"an edge ray set crosses no ray on some edge: {edges}")
    check(sweep_equal, "planets2 frame with sweep='kernel' differs from "
          "the plain frame")

    # whitted_times: both kernels at the planets2 shape on the card's
    # clock, their bounds from this run's data, the frame's wall time.
    t0 = time.perf_counter()
    o, d, R = m["o"], m["d"], m["o"].shape[0]
    mb = m["kw"]["max_bounces"]
    for _ in range(3):
        cuda_whitted.whitted_trace(o, d, None, table, max_bounces=mb)
    w_ms = cuda_ms(lambda: cuda_whitted.whitted_trace(
        o, d, None, table, max_bounces=mb), 20)
    w_plain_ms = cuda_ms(lambda: cuda_whitted.whitted_trace_plain(
        o, d, None, table, max_bounces=mb), 2)
    work = {}
    cuda_whitted.whitted_trace_plain(o, d, None, table, max_bounces=mb,
                                     counters=work)
    w_sweep, w_sweep_every = sweep_ops(work)
    w_rest = whitted_rest_ops(work, R)
    w_ops = w_sweep + w_rest
    w_bytes = (W_BYTES_IN + W_BYTES_OUT) * R
    w_bound, w_by = bound(w_ops, w_bytes)
    # The nearest-hit kernel as the shadow sweep runs it (case a): from the
    # termini toward the first point light, the shaded sphere suppressed.
    nh_args = (*sweep_edges.shadow_rays(m["res_k"], m["pl"], table), table)
    nh_cases = {"a_shadow_planets2": (nh_args, {}),
                "b_level_chandelier_exact": ((l_o, l_d, None, l_table),
                                             {"by_abs": True}),
                "b_level_chandelier_fast": ((l_o, l_d, None, l_table),
                                            {"by_abs": True, "fast": True})}
    nh_times = {}
    for name, (args, kw) in nh_cases.items():
        for _ in range(3):
            cuda_intersect.nearest_hit(*args, **kw)
        ms = cuda_ms(lambda: cuda_intersect.nearest_hit(*args, **kw), 50)
        plain_ms = cuda_ms(lambda: cuda_intersect.nearest_hit_plain(
            *args, **kw), 3)
        n = args[0].shape[0]
        nh_work = cuda_intersect.sweep_work(*args, fast=kw.get("fast", False))
        ops, ops_every = sweep_ops(nh_work)
        nbytes = (W_BYTES_IN + (0 if args[2] is None else W_BYTES_SUPPRESS)
                  + NH_BYTES_OUT) * n
        b_ms, b_by = bound(ops, nbytes)
        nh_times[name] = {
            "rays": n, "spheres": len(args[3].spec), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms, "bytes": nbytes, "ops": ops,
            "ops_every_term": ops_every,
            "bound_ms_every_term": bound(ops_every, nbytes)[0],
            "work": nh_work}
    nh = nh_times["a_shadow_planets2"]
    emit({"phase": "nearest_hit_times", **card, "cases": nh_times,
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    table_ms = []
    for _ in range(20):
        t1 = time.perf_counter()
        material_flags(scene)
        cuda_intersect.sphere_table(scene)
        torch.cuda.synchronize()
        table_ms.append((time.perf_counter() - t1) * 1e3)
    walls = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(5):
        t1 = time.perf_counter()
        render_whitted(scene, m["gl"], m["pl"], o, d, m["h"], m["w"],
                       impl="kernel", **m["kw"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    emit({"phase": "whitted_times", **card,
          "frame": f"planets2 {m['w']}x{m['h']}/{mb}", "rays": R,
          "whitted_trace_ms": w_ms, "whitted_trace_plain_ms": w_plain_ms,
          "whitted_trace_bound_ms": w_bound, "whitted_trace_bound_by": w_by,
          "whitted_trace_bound_ops": w_ops,
          "whitted_trace_bound_ops_every_term": w_sweep_every + w_rest,
          "whitted_trace_bound_bytes": w_bytes,
          "whitted_trace_bound_share": w_bound / w_ms, "work": work,
          "nearest_hit_ms": nh["ms"], "nearest_hit_plain_ms": nh["plain_ms"],
          "nearest_hit_bound_ms": nh["bound_ms"],
          "nearest_hit_bound_by": nh["bound_by"],
          "nearest_hit_bound_share": nh["bound_share"],
          "launches_per_frame": m["launches"],
          "render_whitted_wall_ms": walls,
          "render_whitted_wall_ms_min": min(walls),
          "primary_rays_per_s_wall": R / (min(walls) / 1e3),
          "material_flags_and_sphere_table_host_ms": sorted(table_ms)[10],
          "grid_rays_host_ms": m["camera_ms"],
          "max_memory_allocated_bytes": peak, "library_ms": None,
          "library_note": "no single PyTorch call computes either function",
          "seconds": time.perf_counter() - t0})

    # whitted_shade: the frame's one shading launch, recorded and replayed:
    # bit for bit against terminal_rgb(impl="plain") on its termini, its
    # device time queued against its bound from the work on them.
    t0 = time.perf_counter()
    calls = recorded_launches(cuda_shade, "whitted_shade", lambda: (
        render_whitted(scene, m["gl"], m["pl"], o, d, m["h"], m["w"],
                       impl="kernel", **m["kw"])))
    shade = shade_entry("whitted_shade", calls)
    shade["launches"] = m["launches"]["whitted_shade"]
    emit({"phase": "whitted_shade", **card,
          "frame": f"planets2 {m['w']}x{m['h']}/{mb}", "termini": R,
          "launches_per_frame": m["launches"],
          **{k: shade[k] for k in ("bit_equal", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "bound_share", "bound_ops",
                                   "bound_bytes", "work")},
          "queued_ms": shade["ms"], "library_ms": None,
          "library_note": "no single PyTorch call computes this function",
          "seconds": time.perf_counter() - t0})
    check(len(calls) == 1 and shade["bit_equal"],
          f"whitted_shade: {len(calls)} launches, bit equal "
          f"{shade['bit_equal']}")

    return shade, [
        {"name": "whitted_trace", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/whitted_trace.cu",
         "replaces": "raytracer_tpu/core/pallas_whitted.py:110",
         "launches": m["launches"]["whitted_trace"],
         "max_abs_err": whitted_err, "ms": w_ms, "plain_ms": w_plain_ms,
         "bound_ms": w_bound, "bound_by": w_by, "library_ms": None},
        {"name": "nearest_hit", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/nearest_hit.cu",
         "replaces": "raytracer_tpu/core/pallas_intersect.py:42",
         "launches": m["launches"]["nearest_hit"], "max_abs_err": nh_err,
         "ms": nh["ms"], "plain_ms": nh["plain_ms"],
         "bound_ms": nh["bound_ms"], "bound_by": nh["bound_by"],
         "library_ms": None}]


def student_params(kind, width=G_WIDTH, seed=SEED, hidden=2):
    """A 22->width(->width)->2 student with ``hidden`` layers:
    ``"one_hot"`` (px, py, pz and nx through the hidden layers to a0 = px,
    a1 = -nx; any summation order gives the same floats) or ``"random"``
    (seeded dense weights)."""
    dims = (22,) + (width,) * hidden + (2,)
    if kind == "random":
        rng = np.random.RandomState(seed)
        return {f"Dense_{i}": {
            "kernel": (rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
            "bias": (rng.randn(b) * 0.1).astype(np.float32)}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    k0 = np.zeros((22, width), np.float32)
    for j, c in enumerate((0, 1, 2, 6)):
        k0[c, j] = 1.0
    k2 = np.zeros((width, 2), np.float32)
    k2[0, 0], k2[3, 1] = 1.0, -1.0
    kernels = [k0] + [np.eye(width, dtype=np.float32)] * (hidden - 1) + [k2]
    return {f"Dense_{i}": {"kernel": k,
                           "bias": np.zeros(k.shape[1], np.float32)}
            for i, k in enumerate(kernels)}


def student(kind, width=G_WIDTH, hidden=2, dtype="auto"):
    """``student_params`` as a guide (bf16 for ``dtype="auto"``)."""
    return DistilledGuide(student_params(kind, width, hidden=hidden),
                          (width,) * hidden).as_guide_fn(dtype=dtype)


def route_counts():
    return dict(cuda_path.path_trace.route_launches)


def hits_close(a, b):
    """``a`` within the guided bounds of ``b`` (equal when ``b`` is 0)."""
    return a == b if b == 0 else G_HITS[0] <= a / b <= G_HITS[1]


def compare_guided(rgb_a, st_a, rgb_b, st_b, exact):
    """Samples ``[R, 3]`` and stats of two guided traces: bit for bit when
    ``exact``, else the guided bounds.  Returns ``(ok, report)``."""
    equal = bool(torch.equal(rgb_a, rgb_b)) and st_a == st_b
    frac = float((rgb_a == rgb_b).all(-1).double().mean())
    ok = bool(torch.isfinite(rgb_a).all()) and (equal or (
        not exact and frac >= G_MIN_EQUAL
        and hits_close(st_a["light_hits"], st_b["light_hits"])
        and hits_close(st_a["small_light_hits"], st_b["small_light_hits"])))
    return ok, {"bit_equal": equal, "samples_equal_fraction": frac,
                "max_abs_err": float((rgb_a - rgb_b).abs().max()),
                "stats": st_a, "stats_reference": st_b}


def guided_phases(dev, card, scene, params, libs):
    """The guided path's phases; returns its two ``kernels`` entries."""
    guide = guide_for("chandelier", W, H, STUDENTS_DIR)
    check(guide is not None, f"no shipped student in {STUDENTS_DIR}")
    emit({"phase": "guided_build", "libraries": {
        n: {"library": str(libs[n].path.relative_to(ROOT)),
            "nvcc_seconds": libs[n].build_seconds,
            "ptxas": [ln.strip() for ln in libs[n].build_log.splitlines()
                      if "registers" in ln or "spill" in ln]}
        for n in ("path_trace", "path_guided", "path_level")},
        "path_guided_launch_shipped_student":
            cuda_path.guided_occupancy(guide)})
    gen = torch.Generator(dev).manual_seed(SEED + 10)
    jitter = torch.rand((SPP, H, W, 2), device=dev, generator=gen)
    o, d = perspective_rays(W, H, fov=params["fov"],
                            origin=params["camera_position"],
                            sample_xy=jitter)
    o = o.contiguous()
    R = o.shape[0]
    u = torch.rand((BOUNCES, R, 2), device=dev, generator=gen)
    f = torch.rand((BOUNCES, R), device=dev, generator=gen)
    tkw = dict(max_bounces=BOUNCES, mirror_threshold=G_THRESHOLD,
               background=BG, uniforms=u, fb_uniforms=f, fb_prob=G_FB_PROB)

    def trace(impl, guide):
        rgb, st = trace_path(scene, o, d, impl=impl, guide_fn=guide, **tkw)
        torch.cuda.synchronize()
        return rgb, st.as_dict()

    # guided_one_hot: kernel vs plain with a one-hot and a seeded random
    # 22->128->128->2 student, f32 and bf16.
    t0 = time.perf_counter()
    for kind in ("one_hot", "random"):
        for dtype in (None, "auto"):
            g = student(kind, dtype=dtype)
            rk, sk = trace("kernel", g)
            rp, sp = trace("plain", g)
            ok, rep = compare_guided(rk, sk, rp, sp, exact=kind == "one_hot")
            emit({"phase": "guided_one_hot", "student": kind,
                  "dtype": "bfloat16" if dtype else "float32",
                  "route": cuda_path.guided_route(g),
                  "frame": f"{W}x{H}@{SPP}spp/{BOUNCES}", **rep,
                  "seconds": time.perf_counter() - t0})
            check(ok, f"guided kernel vs plain, {kind} student, {dtype}: "
                  f"{rep}")
            check(sk["fb_used"] > 0, f"{kind} student: no guided bounce")

    # guided_main: the shipped student through render_path, kernel then
    # plain then hybrid on the same draws.
    t0 = time.perf_counter()
    fkw = dict(width=W, height=H, spp=SPP, max_bounces=BOUNCES,
               fov=params["fov"], camera_position=params["camera_position"],
               mirror_threshold=G_THRESHOLD, background=BG, device=dev,
               guide_fn=guide, fb_prob=G_FB_PROB)
    frames, launches = {}, {}
    for impl in ("kernel", "plain", "hybrid"):
        reset_counts()
        img, st = render_path(
            scene, impl=impl,
            generator=torch.Generator(dev).manual_seed(SEED + 11), **fkw)
        torch.cuda.synchronize()
        launches[impl] = {"path_trace": cuda_path.path_trace.launches,
                          "path_trace_routes": route_counts(),
                          "path_level": cuda_level.path_level.launches}
        frames[impl] = (img, st.as_dict())
    img_k, sk = frames["kernel"]
    check(launches["kernel"]["path_trace"] >= 1,
          "the guided path launched no path_trace kernel")
    check(launches["kernel"]["path_trace_routes"]["bf16_mma"]
          == launches["kernel"]["path_trace"],
          f"the shipped bf16 student's frame left the tensor-core route: "
          f"{launches['kernel']}")
    check(launches["hybrid"]["path_level"] >= BOUNCES,
          "the hybrid launched too few path_level kernels")
    check(tuple(img_k.shape) == (H, W, 3) and bool(torch.isfinite(img_k)
                                                   .all()),
          f"guided image {tuple(img_k.shape)} not finite")
    check(sk["fb_used"] > 0 and sk["fb_success"] > 0,
          f"guided stats {sk}: no guided bounce found a light")
    main_ok, main_rep = {}, {}
    for impl in ("plain", "hybrid"):
        img, st = frames[impl]
        pix = float((img_k == img).all(-1).float().mean())
        main_ok[impl] = (bool(torch.equal(img_k, img)) and sk == st) or (
            pix >= G_MIN_EQUAL and hits_close(sk["light_hits"],
                                              st["light_hits"])
            and hits_close(sk["small_light_hits"], st["small_light_hits"]))
        main_rep[impl] = {"bit_equal": bool(torch.equal(img_k, img))
                          and sk == st, "pixels_equal_fraction": pix,
                          "stats": st}
    # The same student, sample by sample, on the frame's draws.
    rk, sk_s = trace("kernel", guide)
    rp, sp_s = trace("plain", guide)
    ok_s, rep_s = compare_guided(rk, sk_s, rp, sp_s, exact=False)
    emit({"phase": "guided_main", "frame": f"{W}x{H}@{SPP}spp/{BOUNCES}",
          "student": "fb_chandelier_distilled.npz (bf16)",
          "launches": launches, "stats_kernel": sk,
          "plain_vs_kernel": main_rep["plain"],
          "hybrid_vs_kernel": main_rep["hybrid"],
          "samples_kernel_vs_plain": {k: v for k, v in rep_s.items()
                                      if k != "stats_reference"},
          "seconds": time.perf_counter() - t0})
    for impl in ("plain", "hybrid"):
        check(main_ok[impl], f"guided frame, kernel vs {impl}: "
              f"{main_rep[impl]}")
    check(ok_s, f"guided samples, kernel vs plain: {rep_s}")

    # guided_edges: the tensor-core route's edge cases on the frame's
    # draws, kernel against plain and hybrid against kernel, one-hot
    # students bit for bit and dense ones within the guided bounds: a
    # ragged ray count (3,601 of the frame's rays, a seeded choice),
    # fb_prob 0.5 (warps with every number of guided lanes), one hidden
    # layer, width 24 (not a multiple of 16); then, at fb_prob 0, the
    # route against the unguided kernel on the same uniforms.
    t0 = time.perf_counter()
    pick = torch.randperm(R, device=dev, generator=torch.Generator(
        dev).manual_seed(SEED + 13))[:3601]
    ragged = (o[pick].contiguous(), d[pick].contiguous(),
              u[:, pick].contiguous(), f[:, pick].contiguous())
    full = (o, d, u, f)
    edges, edges_ok = [], True
    for name, kind, width, hidden, fb_prob, rays in (
            ("ragged_3601", "one_hot", G_WIDTH, 2, 1.0, ragged),
            ("fb_prob_0.5", "one_hot", G_WIDTH, 2, 0.5, full),
            ("one_hidden_layer", "one_hot", G_WIDTH, 1, 1.0, full),
            ("width_24", "one_hot", 24, 2, 1.0, full),
            ("ragged_3601", "random", G_WIDTH, 2, 0.5, ragged),
            ("one_hidden_layer", "random", G_WIDTH, 1, 1.0, full),
            ("width_24", "random", 24, 2, 0.5, full)):
        g = student(kind, width, hidden)
        eo, ed, eu, ef = rays
        ekw = dict(max_bounces=BOUNCES, mirror_threshold=G_THRESHOLD,
                   background=BG, uniforms=eu, fb_uniforms=ef,
                   fb_prob=fb_prob, guide_fn=g)
        before = route_counts()["bf16_mma"]
        out = {}
        for impl in ("kernel", "plain", "hybrid"):
            rgb, st = trace_path(scene, eo, ed, impl=impl, **ekw)
            out[impl] = (rgb, st.as_dict())
        torch.cuda.synchronize()
        routed = route_counts()["bf16_mma"] - before
        exact = kind == "one_hot"
        ok_p, rep_p = compare_guided(*out["kernel"], *out["plain"], exact)
        ok_h, rep_h = compare_guided(*out["hybrid"], *out["kernel"], exact)
        keep = ("bit_equal", "samples_equal_fraction", "max_abs_err")
        edges.append({
            "case": name, "student": f"{kind} 22->"
            + "->".join([str(width)] * hidden) + "->2 bf16",
            "fb_prob": fb_prob, "rays": eo.shape[0],
            "fb_used": out["kernel"][1]["fb_used"],
            "bf16_mma_launches": routed,
            "kernel_vs_plain": {k: rep_p[k] for k in keep},
            "hybrid_vs_kernel": {k: rep_h[k] for k in keep}})
        edges_ok &= (ok_p and ok_h and routed == 1
                     and out["kernel"][1]["fb_used"] > 0)
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 G_THRESHOLD, dev)
    rgb0, cnt0 = cuda_path.path_trace(o, d, u, table, max_bounces=BOUNCES,
                                      background=BG, guide=guide,
                                      fb_uniforms=f, fb_prob=0.0)
    rgb_u, cnt_u = cuda_path.path_trace(o, d, u, table, max_bounces=BOUNCES,
                                        background=BG)
    torch.cuda.synchronize()
    fb0_equal = (bool(torch.equal(rgb0, rgb_u))
                 and bool(torch.equal(cnt0[:, :4], cnt_u))
                 and not bool(cnt0[:, 4:].any()))
    emit({"phase": "guided_edges", "cells": edges,
          "fb_prob_0_equals_unguided_kernel": fb0_equal,
          "seconds": time.perf_counter() - t0})
    check(edges_ok, f"tensor-core route edge cases: {edges}")
    check(fb0_equal, "the tensor-core route at fb_prob 0 differs from the "
          "unguided kernel on the same uniforms")

    # guided_hits: small-light hits, guided over traditional, both shipped
    # chandelier students, at bench.py's two guided shapes.
    t0 = time.perf_counter()
    hits = []
    for w, h in ((200, 100), (W, H)):
        hkw = dict(width=w, height=h, spp=SPP, max_bounces=BOUNCES,
                   fov=params["fov"], camera_position=params["camera_position"],
                   background=BG, device=dev)
        _, st_t = render_path(
            scene, mirror_threshold=0.0,
            generator=torch.Generator(dev).manual_seed(SEED + 12), **hkw)
        trad = int(st_t.small_light_hits)
        for name in ("fb_chandelier_distilled.npz",
                     "fb_chandelier_distilled_2to1.npz"):
            g = DistilledGuide.load(STUDENTS_DIR / name).as_guide_fn()
            _, st_g = render_path(
                scene, mirror_threshold=G_THRESHOLD, guide_fn=g,
                fb_prob=G_FB_PROB,
                generator=torch.Generator(dev).manual_seed(SEED + 12), **hkw)
            hits.append({"frame": f"{w}x{h}@{SPP}spp/{BOUNCES}",
                         "student": name,
                         "registry_pick": name == Path(model_path_for(
                             "chandelier", w, h, STUDENTS_DIR)).name,
                         "small_light_hits_guided":
                             int(st_g.small_light_hits),
                         "small_light_hits_traditional": trad,
                         "small_light_improvement":
                             int(st_g.small_light_hits) / max(trad, 1),
                         "fb_used": int(st_g.fb_used),
                         "fb_success": int(st_g.fb_success)})
            check(trad > 0 and int(st_g.small_light_hits) > 0,
                  f"guided_hits: no small-light hit ({hits[-1]})")
    emit({"phase": "guided_hits", "cells": hits,
          "seconds": time.perf_counter() - t0})

    # level_kernel: every level of a guided hybrid trace through the level
    # kernel and its plain version on the same inputs, bit for bit; then
    # the hybrid trace against the whole-trace kernel.
    t0 = time.perf_counter()
    kernel_level = cuda_level.path_level
    recorded, level_equal, level_err = [], [], [0.0]

    def checked_level(lo, ld, lrun, lu, ltable, **kw):
        a = kernel_level(lo, ld, lrun, lu, ltable, **kw)
        b = cuda_level.path_level_plain(lo, ld, lrun, lu, ltable, **kw)
        level_equal.append(all(
            (x is None and y is None) or bool(torch.equal(x, y))
            for x, y in zip(a, b)))
        level_err[0] = max([level_err[0]] + [
            float((x - y).abs().max()) for x, y in zip(a[1:], b[1:])
            if x is not None])
        recorded.append(((lo, ld, lrun, lu, ltable), kw, a.state))
        return a

    # While it stands in for the wrapper, the wrapper's launches land on
    # checked_level.launches: launches made to compare do not count.
    checked_level.launches = 0
    cuda_level.path_level = checked_level
    try:
        rh, sh = trace("hybrid", guide)
    finally:
        cuda_level.path_level = kernel_level
    rk, sk = trace("kernel", guide)
    ok_h, rep_h = compare_guided(rh, sh, rk, sk, exact=False)
    one_hot = DistilledGuide(student_params("one_hot"), (G_WIDTH, G_WIDTH)
                             ).as_guide_fn()
    rh1, sh1 = trace("hybrid", one_hot)
    rk1, sk1 = trace("kernel", one_hot)
    ok_h1, rep_h1 = compare_guided(rh1, sh1, rk1, sk1, exact=True)
    emit({"phase": "level_kernel", "levels": len(level_equal),
          "levels_bit_equal": level_equal,
          "hybrid_vs_kernel_shipped": rep_h,
          "hybrid_vs_kernel_one_hot": rep_h1,
          "seconds": time.perf_counter() - t0})
    check(len(level_equal) == BOUNCES and all(level_equal),
          f"path_level kernel vs plain differ: {level_equal}")
    check(ok_h and ok_h1, f"hybrid vs whole-trace kernel: {rep_h}, {rep_h1}")

    # guided_times: both kernels at the guided frame's shapes on the card's
    # clock, their bounds from this run's data, the frames' wall times.
    t0 = time.perf_counter()
    gkw = dict(max_bounces=BOUNCES, background=BG, guide=guide,
               fb_uniforms=f, fb_prob=G_FB_PROB)
    _, cnt = cuda_path.path_trace(o, d, u, table, **gkw)
    for _ in range(2):
        cuda_path.path_trace(o, d, u, table, **gkw)
    g_ms = cuda_ms(lambda: cuda_path.path_trace(o, d, u, table, **gkw), 5)
    g_plain_ms = cuda_ms(lambda: cuda_path.path_trace_plain(
        o, d, u, table, **gkw), 1)
    # The level's work on the guided frame's data: the hybrid's levels,
    # which are the plain version's (level_kernel holds the level kernel to
    # level_plain bit for bit), the kernel's up to the samples where the
    # tensor cores' student differs (guided_main).
    l_work = {}
    for (lo, ld, lrun, lu, ltable), kw, _ in recorded:
        add_work(l_work, level_edges.level_work(lo, ld, lrun, lu, ltable))
    l_ops, l_ops_plain = level_ops(l_work)
    f32_ops = l_ops + OPS_PER_RAY * R
    fb_used = int(cnt[:, 4].sum(dtype=torch.int64))
    mlp_flops = STUDENT_FLOPS * fb_used
    g_bytes = G_BYTES_PER_RAY * R + G_BYTES_FB * fb_used
    t_ops = f32_ops / PEAK_F32_OPS * 1e3 + mlp_flops / PEAK_BF16 * 1e3
    t_bytes = g_bytes / PEAK_BYTES * 1e3
    g_bound = max(t_ops, t_bytes)
    g_by = "operations" if t_ops >= t_bytes else "bytes"
    # The split: the same kernel at fb_prob 0, no lane guided (its paths
    # take cosine bounces instead, so its ray-levels differ; both counted).
    gkw0 = dict(gkw, fb_prob=0.0)
    _, cnt0 = cuda_path.path_trace(o, d, u, table, **gkw0)
    g0_ms = cuda_ms(lambda: cuda_path.path_trace(o, d, u, table, **gkw0), 5)
    # Its work: the unguided plain trace on the same uniforms (guided_edges
    # holds the two kernels equal at fb_prob 0).
    _, _, work0 = traced_work(o, d, u, table, max_bounces=BOUNCES,
                              background=BG)
    f32_ops0 = level_ops(work0)[0] + OPS_PER_RAY * R
    g0_bound, g0_by = bound(f32_ops0, BYTES_PER_RAY * R)
    levels = {name: int(torch.clamp_max(c[:, 0], BOUNCES).sum(
        dtype=torch.int64)) for name, c in (("fb_prob_1", cnt),
                                            ("fb_prob_0", cnt0))}
    # The unguided kernel (one thread a ray) on that same work: guided_edges
    # holds the two equal.
    ukw = dict(max_bounces=BOUNCES, background=BG)
    cuda_path.path_trace(o, d, u, table, **ukw)
    u0_ms = cuda_ms(lambda: cuda_path.path_trace(o, d, u, table, **ukw), 5)
    # The shipped student in f32 on the scalar route (csrc/path_trace.cu).
    gkw32 = dict(gkw, guide=DistilledGuide.load(
        STUDENTS_DIR / "fb_chandelier_distilled.npz").as_guide_fn(None))
    cuda_path.path_trace(o, d, u, table, **gkw32)
    g32_ms = cuda_ms(lambda: cuda_path.path_trace(o, d, u, table, **gkw32),
                     2)

    def level_frame():
        for args, kw, _ in recorded:
            kernel_level(*args, **kw)

    level_frame()
    l_ms = cuda_ms(level_frame, 5)
    l_plain_ms = cuda_ms(lambda: [cuda_level.path_level_plain(*a, **kw)
                                  for a, kw, _ in recorded], 1)
    l_bytes = 0
    for (lo, ld, lrun, lu, _), kw, st in recorded:
        diffuse = int((((st & cuda_level.ST_CONT) != 0)
                       & ((st & cuda_level.ST_MIRROR) == 0)).sum())
        l_bytes += ((LVL_BYTES_PER_RAY
                     + (LVL_BYTES_HIT if kw.get("want_hit") else 0))
                    * lo.shape[0] + LVL_BYTES_U * diffuse)
    l_bound, l_by = bound(l_ops, l_bytes)
    walls = {}
    for impl in ("kernel", "hybrid"):
        walls[impl] = []
        for _ in range(3):
            t1 = time.perf_counter()
            render_path(scene, impl=impl,
                        generator=torch.Generator(dev).manual_seed(SEED + 11),
                        **fkw)
            torch.cuda.synchronize()
            walls[impl].append((time.perf_counter() - t1) * 1e3)
    emit({"phase": "guided_times", **card,
          "frame": f"{W}x{H}@{SPP}spp/{BOUNCES} guided", "rays": R,
          "path_trace_guided_ms": g_ms,
          "path_trace_guided_plain_ms": g_plain_ms,
          "path_trace_guided_bound_ms": g_bound,
          "path_trace_guided_bound_by": g_by,
          "path_trace_guided_bound_f32_ops": f32_ops,
          "path_trace_guided_bound_mlp_flops": mlp_flops,
          "path_trace_guided_bound_bytes": g_bytes,
          "path_trace_guided_bound_share": g_bound / g_ms,
          "guided_ray_levels": fb_used,
          "path_trace_guided_fb_prob_0_ms": g0_ms,
          "path_trace_guided_fb_prob_0_bound_ms": g0_bound,
          "path_trace_guided_fb_prob_0_bound_by": g0_by,
          "path_trace_guided_fb_prob_0_bound_f32_ops": f32_ops0,
          "ray_levels_run": levels,
          "path_trace_unguided_fb_prob_0_work_ms": u0_ms,
          "path_trace_guided_f32_student_ms": g32_ms,
          "path_level_ms_per_frame": l_ms, "path_level_launches": len(recorded),
          "path_level_plain_ms_per_frame": l_plain_ms,
          "path_level_bound_ms": l_bound, "path_level_bound_by": l_by,
          "path_level_bound_ops": l_ops, "path_level_bound_bytes": l_bytes,
          "path_level_bound_share": l_bound / l_ms,
          "path_level_plain_ops": l_ops_plain, "level_work": l_work,
          "render_path_kernel_wall_ms": walls["kernel"],
          "render_path_hybrid_wall_ms": walls["hybrid"],
          "library_ms": None,
          "library_note": "no single PyTorch call computes either function",
          "seconds": time.perf_counter() - t0})

    return [
        {"name": "path_trace_guided", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/path_guided.cu",
         "replaces": "raytracer_tpu/core/pallas_path.py:142",
         "launches": launches["kernel"]["path_trace"],
         "max_abs_err": float((frames["kernel"][0]
                               - frames["plain"][0]).abs().max()),
         "ms": g_ms, "plain_ms": g_plain_ms, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": None},
        {"name": "path_level", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/path_level.cu",
         "replaces": "raytracer_tpu/core/pallas_path.py:562",
         "launches": launches["hybrid"]["path_level"],
         "max_abs_err": level_err[0],
         "ms": l_ms, "plain_ms": l_plain_ms, "bound_ms": l_bound,
         "bound_by": l_by, "library_ms": None}]


def agent_guide_flops(cfg):
    """Flops of one guide row at ``cfg``'s widths, two a multiply-add: the
    encoder's products (obs->e, its three residual blocks, the attention's
    value and out projections, e->e, e->2z) and the backward model's trunk
    and mean head (2z->b, two residual blocks, b->2)."""
    e, b, z = cfg.e_hidden_dim, cfg.b_hidden_dim, cfg.z_dim
    enc = cfg.obs_dim * e + 3 * 2 * e * e + 2 * e * e + e * e + e * 2 * z
    bwd = 2 * z * b + 2 * 2 * b * b + b * cfg.action_dim
    return 2 * (enc + bwd)


class TimedGuide:
    """A guide with CUDA events around each call; ``ms()`` sums them."""

    def __init__(self, guide):
        self.guide, self.events = guide, []

    def __call__(self, obs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.guide(obs)
        b.record()
        self.events.append((a, b))
        return out

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def queued_ms(fn, reps=10, spin_cycles=20_000_000):
    """Device milliseconds of one call of ``fn`` on the card's clock: CUDA
    events around ``reps`` calls whose launches the host queued behind a
    spin kernel (``torch.cuda._sleep``), so the events bracket the kernels
    run back to back and not the host's launch overhead.  The spin doubles
    until it outlasts the host's queueing.  Used for the recorded launches
    of a frame or a walk, a few microseconds each, where events around the
    wrapper calls time the host."""
    fn()
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(spin_cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        spin_cycles *= 2
    raise PhaseError(f"queued_ms: the host took {host_ms:.3f} ms to queue "
                     f"{reps} calls, longer than the spin")


def recorded_launches(module, name, frame):
    """Run ``frame()`` with ``module.<name>`` (a kernel wrapper) recording
    its calls: ``[(args, kwargs, output)]``.  While it stands in for the
    wrapper, the wrapper's launches land on the recorder's own count."""
    real, calls = getattr(module, name), []

    def recorder(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    recorder.launches = 0
    setattr(module, name, recorder)
    try:
        frame()
    finally:
        setattr(module, name, real)
    torch.cuda.synchronize()
    return calls


def fb_agent_phases(dev, card, scene, params):
    """The full FB agent's phases (bench.py's full-agent cell): the main
    path through render_path on three routes, each bit for bit against the
    others where their semantics meet, then their times and one larger
    frame."""
    # fb_agent: f32 stays f32 on the card (TF32 is another precision).
    t0 = time.perf_counter()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "torch.backends.cuda.matmul.allow_tf32 is on: TF32 matmuls")
    check(torch.get_float32_matmul_precision() == "highest",
          f"float32 matmul precision is "
          f"{torch.get_float32_matmul_precision()!r}, not 'highest'")
    cfg = FBConfig()
    agent = TrainedFBAgent(None, scene, small_light_indices(scene),
                           params["camera_position"], config=cfg, seed=SEED,
                           device=dev)
    guide = agent.as_guide_fn()
    fkw = dict(width=A_W, height=A_H, spp=SPP, max_bounces=BOUNCES,
               fov=params["fov"], camera_position=params["camera_position"],
               mirror_threshold=G_THRESHOLD, background=BG, device=dev,
               fb_prob=G_FB_PROB)
    routes = {"stepwise": dict(impl="stepwise"),
              f"stepwise_guide_max_level_{A_GML}": dict(
                  impl="stepwise", guide_max_level=A_GML),
              "hybrid": dict(impl="hybrid")}

    def frame(rkw, g=guide, **kw):
        out = render_path(scene, guide_fn=g, **rkw, **dict(fkw, **kw),
                          generator=torch.Generator(dev).manual_seed(
                              SEED + 40))
        torch.cuda.synchronize()
        return out

    frames, launches = {}, {}
    for name, rkw in routes.items():
        reset_counts()
        img, st = frame(rkw)
        launches[name] = {
            "nearest_hit": cuda_intersect.nearest_hit.launches,
            "path_level": cuda_level.path_level.launches,
            "path_trace": cuda_path.path_trace.launches,
            "guide_norm": cuda_norm.guide_norm.launches}
        frames[name] = (img, st.as_dict())
        check(tuple(img.shape) == (A_H, A_W, 3)
              and bool(torch.isfinite(img).all()),
              f"fb_agent {name}: image {tuple(img.shape)} not finite")
        check(st.as_dict()["fb_used"] > 0, f"fb_agent {name}: no guided "
              f"bounce ({st.as_dict()})")
    gml = f"stepwise_guide_max_level_{A_GML}"
    for name in ("stepwise", gml):
        check(launches[name]["nearest_hit"] == BOUNCES
              and launches[name]["path_level"] == 0,
              f"fb_agent {name}: launches {launches[name]}, not one "
              f"nearest_hit a level")
    check(launches["hybrid"]["path_level"] == BOUNCES
          and launches["hybrid"]["nearest_hit"] == 0,
          f"fb_agent hybrid: launches {launches['hybrid']}")
    # The f32 guide's row kernel: GN_SITES launches a guided level.
    for name, rkw in routes.items():
        levels = rkw.get("guide_max_level", BOUNCES)
        check(launches[name]["guide_norm"] == GN_SITES * levels,
              f"fb_agent {name}: {launches[name]['guide_norm']} guide_norm "
              f"launches, not {GN_SITES} a guided level of {levels}")

    # The same agent on the frame's draws through trace_path: the stepwise
    # route with the kernel sweep and with nearest_hit_plain as its sweep,
    # the hybrid, and guide_max_level=3 against the hybrid whose fb plane is
    # 2.0 (never below fb_prob) from level 3 on.
    gen = torch.Generator(dev).manual_seed(SEED + 41)
    jitter = torch.rand((SPP, A_H, A_W, 2), device=dev, generator=gen)
    o, d = perspective_rays(A_W, A_H, fov=params["fov"],
                            origin=params["camera_position"],
                            sample_xy=jitter)
    o = o.contiguous()
    R = o.shape[0]
    u = torch.rand((BOUNCES, R, 2), device=dev, generator=gen)
    f = torch.rand((BOUNCES, R), device=dev, generator=gen)
    tkw = dict(max_bounces=BOUNCES, mirror_threshold=G_THRESHOLD,
               background=BG, uniforms=u, fb_uniforms=f, fb_prob=G_FB_PROB,
               guide_fn=guide)

    def trace(impl, **kw):
        rgb, st = trace_path(scene, o, d, impl=impl, **dict(tkw, **kw))
        torch.cuda.synchronize()
        return rgb, st.as_dict()

    out = {"stepwise": trace("stepwise")}
    kernel_hit = cuda_intersect.nearest_hit
    cuda_intersect.nearest_hit = cuda_intersect.nearest_hit_plain
    try:
        out["stepwise_plain_sweep"] = trace("stepwise")
    finally:
        cuda_intersect.nearest_hit = kernel_hit
    out["hybrid"] = trace("hybrid")
    out[gml] = trace("stepwise", guide_max_level=A_GML)
    f3 = f.clone()
    f3[A_GML:] = 2.0
    out[f"hybrid_fb_plane_past_level_{A_GML}"] = trace("hybrid",
                                                       fb_uniforms=f3)

    def same(a, b):
        return bool(torch.equal(out[a][0], out[b][0])) and out[a][1] == \
            out[b][1]

    agree = {
        "stepwise_kernel_vs_plain_sweep": same("stepwise",
                                               "stepwise_plain_sweep"),
        "stepwise_vs_hybrid": same("stepwise", "hybrid"),
        f"{gml}_vs_hybrid_fb_plane_past_level_{A_GML}": same(
            gml, f"hybrid_fb_plane_past_level_{A_GML}"),
        "render_path_stepwise_vs_hybrid": bool(torch.equal(
            frames["stepwise"][0], frames["hybrid"][0]))
        and frames["stepwise"][1] == frames["hybrid"][1]}
    fb_full, fb_gml = out["stepwise"][1]["fb_used"], out[gml][1]["fb_used"]
    emit({"phase": "fb_agent", "frame": f"{A_W}x{A_H}@{SPP}spp/{BOUNCES}",
          "agent": f"FBConfig() z {cfg.z_dim}, encoder {cfg.e_hidden_dim}, "
                   f"backward {cfg.b_hidden_dim}, seeded (seed {SEED})",
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision(),
          "launches": launches, "bit_equal": agree,
          "max_abs_err_stepwise_vs_hybrid": float(
              (out["stepwise"][0] - out["hybrid"][0]).abs().max()),
          "stats": {k: v[1] for k, v in out.items()},
          "render_path_stats": {k: v[1] for k, v in frames.items()},
          "seconds": time.perf_counter() - t0})
    check(all(agree.values()), f"fb_agent: routes differ: {agree}")
    check(0 < fb_gml < fb_full, f"fb_agent: guide_max_level={A_GML} "
          f"guided {fb_gml} bounces, every level {fb_full}")

    # fb_agent_times: each route's frame on the host clock, the guide in
    # CUDA events around its calls, the route's kernels a frame (their
    # launches recorded in one frame and replayed: device time queued behind
    # a spin kernel, and the wrapper calls in CUDA events), peak memory.
    t0 = time.perf_counter()
    row_flops = agent_guide_flops(cfg)
    times = {}
    for name, rkw in routes.items():
        frame(rkw)
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            frame(rkw)
            walls.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev)
        timed = TimedGuide(guide)
        frame(rkw, timed)
        guide_ms, guide_calls = timed.ms(), len(timed.events)
        hybrid = rkw["impl"] == "hybrid"
        mod, attr, plain = ((cuda_level, "path_level",
                             cuda_level.path_level_plain) if hybrid else
                            (cuda_intersect, "nearest_hit",
                             cuda_intersect.nearest_hit_plain))
        calls = recorded_launches(mod, attr, lambda: frame(rkw))
        real = getattr(mod, attr)

        def replay(fn=real):
            for args, kw, _ in calls:
                fn(*args, **kw)

        replay()
        k_ms = cuda_ms(replay, 5)
        k_dev_ms = queued_ms(replay)
        k_plain_ms = cuda_ms(lambda: replay(plain), 1)
        if hybrid:
            work, k_bytes = {}, 0
            for (lo, ld, lrun, lu, ltable), kw, lv in calls:
                add_work(work, level_edges.level_work(lo, ld, lrun, lu,
                                                      ltable))
                diffuse = int((((lv.state & cuda_level.ST_CONT) != 0)
                               & ((lv.state & cuda_level.ST_MIRROR) == 0))
                              .sum())
                k_bytes += ((LVL_BYTES_PER_RAY + (LVL_BYTES_HIT if
                                                  kw.get("want_hit") else 0))
                            * lo.shape[0] + LVL_BYTES_U * diffuse)
            k_ops = level_ops(work)[0]
        else:
            work, k_bytes = {}, 0
            for (lo, ld, sup, stable), kw, _ in calls:
                add_work(work, cuda_intersect.sweep_work(
                    lo, ld, sup, stable, fast=kw.get("fast", False)))
                k_bytes += (W_BYTES_IN + NH_BYTES_OUT) * lo.shape[0]
            k_ops = sweep_ops(work)[0]
        k_bound, k_by = bound(k_ops, k_bytes)
        g_levels = A_GML if "guide_max_level" in rkw else BOUNCES
        g_flops = g_levels * R * row_flops
        g_bound = g_flops / PEAK_F32_FLOPS * 1e3
        wall = sorted(walls)[1]
        times[name] = {
            "frame_wall_ms": walls, "frame_wall_ms_median": wall,
            "guide_ms": guide_ms, "guide_calls": guide_calls,
            "guide_share_of_wall": guide_ms / wall,
            "guide_flops": g_flops, "guide_bound_ms": g_bound,
            "guide_bound_share": g_bound / guide_ms,
            "kernel": attr, "kernel_launches": len(calls),
            "kernel_device_ms_per_frame": k_dev_ms,
            "kernel_device_ms_per_launch": k_dev_ms / len(calls),
            "kernel_wrapper_ms_per_frame": k_ms,
            "kernel_plain_ms_per_frame": k_plain_ms,
            "kernel_bound_ms_per_frame": k_bound,
            "kernel_bound_by": k_by, "kernel_bound_ops": k_ops,
            "kernel_bound_bytes": k_bytes,
            "kernel_bound_share": k_bound / max(k_dev_ms, 1e-9),
            "kernel_work": work,
            "max_memory_allocated_bytes": peak}
    emit({"phase": "fb_agent_times", **card,
          "frame": f"{A_W}x{A_H}@{SPP}spp/{BOUNCES}", "rays": R,
          "guide_flops_per_row": row_flops,
          "guide_bound_rate_flops": PEAK_F32_FLOPS, "routes": times,
          "library_ms": None,
          "library_note": "no single PyTorch call computes either kernel's "
                          "function",
          "seconds": time.perf_counter() - t0})

    # fb_agent_800x600: the stepwise route once at 800x600@8spp/8 with
    # guide_max_level=3: its time, its guide's and its peak memory, or the
    # out-of-memory error.
    t0 = time.perf_counter()
    big = {"frame": f"{A_BIG_W}x{A_BIG_H}@{SPP}spp/{BOUNCES}",
           "guide_max_level": A_GML}
    del out, frames, calls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    timed = TimedGuide(guide)
    try:
        t1 = time.perf_counter()
        img, st = frame(routes[gml], timed, width=A_BIG_W, height=A_BIG_H)
        big["wall_ms"] = (time.perf_counter() - t1) * 1e3
        big["guide_ms"] = timed.ms()
        big["guide_bound_ms"] = (A_GML * A_BIG_W * A_BIG_H * SPP * row_flops
                                 / PEAK_F32_FLOPS * 1e3)
        big["guide_bound_share"] = big["guide_bound_ms"] / big["guide_ms"]
        big["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            dev)
        big["stats"] = st.as_dict()
        big["fits"] = True
        check(bool(torch.isfinite(img).all()) and st.as_dict()["fb_used"] > 0,
              f"fb_agent_800x600: {st.as_dict()}")
    except torch.cuda.OutOfMemoryError as e:
        big.update(fits=False, error=str(e)[:600],
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                       dev))
    img = st = timed = None
    torch.cuda.empty_cache()
    emit({"phase": "fb_agent_800x600", **card, **big,
          "seconds": time.perf_counter() - t0})
    return {name: v["guide_norm"] for name, v in launches.items()}


def perturbed(module, seed):
    """Every Dense bias and LayerNorm parameter of ``module`` moved off
    flax's initial zeros and ones, so that a kernel that skipped a bias add
    or a scale would not read equal."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, LayerNorm):
                m.scale.copy_(1.0 + 0.2 * torch.randn(m.scale.shape,
                                                      generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return module


def guide_norm_phase(dev, card, scene, params, frame_launches):
    """guide_norm: the f32 guide's row kernel.  A seeded FBConfig() agent
    with every bias and LayerNorm parameter perturbed guides one hybrid
    level's observations; each of the call's sites (every kind of site at
    every width the guide holds) is held bit for bit against the plain ops
    on the same inputs, and the call fused against the module path.  Then
    one [160,000, 512] LayerNorm + residual site (the first residual
    block's second layer) against the plain ops, and its device time queued
    against the byte bound.  ``frame_launches``: fb_agent's launches a
    frame by route.  Returns the kernel's entry of the ``kernels`` line."""
    t0 = time.perf_counter()
    agent = TrainedFBAgent(None, scene, small_light_indices(scene),
                           params["camera_position"], config=FBConfig(),
                           seed=SEED, device=dev)
    perturbed(agent.encoder, SEED + 62)
    perturbed(agent.backward, SEED + 63)
    guide = agent.as_guide_fn()
    check(guide.fused, "guide_norm: the FBConfig() f32 guide is not fused")
    gen = torch.Generator(dev).manual_seed(SEED + 61)
    jitter = torch.rand((SPP, A_H, A_W, 2), device=dev, generator=gen)
    o, d = perspective_rays(A_W, A_H, fov=params["fov"],
                            origin=params["camera_position"],
                            sample_xy=jitter)
    R = o.shape[0]
    u = torch.rand((BOUNCES, R, 2), device=dev, generator=gen)
    f = torch.rand((BOUNCES, R), device=dev, generator=gen)
    seen = []

    def recording(obs):
        seen.append(obs.clone())
        return guide(obs)

    trace_path(scene, o.contiguous(), d, max_bounces=BOUNCES,
               mirror_threshold=G_THRESHOLD, background=BG, uniforms=u,
               fb_uniforms=f, fb_prob=G_FB_PROB, guide_fn=recording,
               impl="hybrid")
    obs = seen[1]
    sites = []
    kernel = fused_guide.guide_norm

    def held(y, bias, ln=None, post=None):
        want = cuda_norm.guide_norm_plain(y.clone(), bias, ln, post)
        got = kernel(y, bias, ln, post)
        residual = isinstance(post, torch.Tensor)
        sites.append({
            "kind": ("ln" if ln is not None else "bias",
                     "residual" if residual else post, y.shape[1]),
            "bit_equal": bool(torch.equal(got, want)),
            "max_rel_gap": float(((got - want).abs()
                                  / want.abs().clamp_min(1.0)).max())})
        return got

    before = cuda_norm.guide_norm.launches
    fused_guide.guide_norm = held
    try:
        fused = guide(obs)
    finally:
        fused_guide.guide_norm = kernel
    torch.cuda.synchronize()
    launches = cuda_norm.guide_norm.launches - before
    fused_ms = cuda_ms(lambda: guide(obs), 5)
    calls = profiling.counters()["guide_module_calls"]
    guide.fused = False
    try:
        modules = guide(obs)
        modules_ms = cuda_ms(lambda: guide(obs), 5)
    finally:
        guide.fused = True
    module_calls = profiling.counters()["guide_module_calls"] - calls
    action_gap = float((fused - modules).abs().max())
    g_bound = R * agent_guide_flops(agent.config) / PEAK_F32_FLOPS * 1e3
    kinds = {tuple(s["kind"]) for s in sites}
    sites_equal = all(s["bit_equal"] for s in sites)

    block = agent.encoder.ResidualBlock_0
    x = torch.randn((GN_ROWS, GN_WIDTH), device=dev, generator=gen)
    with torch.inference_mode():
        bias, ln = block.Dense_1.bias, block.LayerNorm_1
        y = torch.matmul(x, block.Dense_1.kernel)
        want = cuda_norm.guide_norm_plain(y.clone(), bias, ln, x)
        before = cuda_norm.guide_norm.launches
        got = cuda_norm.guide_norm(y.clone(), bias, ln, x)
        torch.cuda.synchronize()
        check(cuda_norm.guide_norm.launches == before + 1,
              "guide_norm: not one launch a site")
        gap = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        equal = float((got == want).float().mean())
        bit_equal = bool(torch.equal(got, want))
        ms = queued_ms(lambda: cuda_norm.guide_norm(y, bias, ln, x))
        plain_ms = cuda_ms(lambda: cuda_norm.guide_norm_plain(y, bias, ln,
                                                              x), 5)
    bound_ms = GN_BYTES / PEAK_BYTES * 1e3
    emit({"phase": "guide_norm", **card,
          "agent": "FBConfig() seeded, biases and LayerNorm parameters "
                   "perturbed",
          "guide_rows": obs.shape[0], "guide_launches_a_call": launches,
          "sites": [dict(s, kind=list(s["kind"])) for s in sites],
          "sites_bit_equal_vs_plain": sites_equal,
          "guide_fused_ms": fused_ms, "guide_modules_ms": modules_ms,
          "guide_module_calls": module_calls,
          "guide_flops_bound_ms": g_bound,
          "guide_fused_bound_share": g_bound / fused_ms,
          "guide_modules_bound_share": g_bound / modules_ms,
          "max_abs_action_gap_fused_vs_modules": action_gap,
          "actions_bit_equal": bool(torch.equal(fused, modules)),
          "site": f"[{GN_ROWS}, {GN_WIDTH}] LayerNorm + residual",
          "bit_equal_vs_plain": bit_equal, "max_rel_gap_vs_plain": gap,
          "equal_fraction_vs_plain": equal,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_bytes": GN_BYTES, "bound_share": bound_ms / ms,
          "frame_launches": frame_launches,
          "seconds": time.perf_counter() - t0})
    check(launches == GN_SITES, f"guide_norm: {launches} launches a guide "
          f"call, not {GN_SITES}")
    check(kinds == GN_KINDS, f"guide_norm: the guide's sites "
          f"{sorted(kinds, key=str)}, not {sorted(GN_KINDS, key=str)}")
    check(sites_equal, f"guide_norm: the guide's sites vs plain: "
          f"{[s for s in sites if not s['bit_equal']]}")
    check(bit_equal, f"guide_norm: kernel vs plain: {equal} of the values "
          f"equal, max rel gap {gap}")
    check(module_calls == 6, f"guide_norm: {module_calls} module-path "
          f"calls counted, not 6")
    check(action_gap <= 2e-5, f"guide_norm: fused guide vs modules "
          f"{action_gap}")
    return {"name": "guide_norm", "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/guide_norm.cu",
            "replaces": None, "launches": frame_launches,
            "launches_timed": 1, "max_abs_err": gap, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_bytes": GN_BYTES, "library_ms": None}


def nan_equal(a, b):
    """Bit-level equality of two tensors, NaN equal to NaN (a walker that
    finds nothing has a point at float32 max along its ray)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def walk_sweep(scene, draws, guide=None):
    """One walk of the chandelier trainer's shape with its nearest-hit
    calls recorded: ``(batch, calls)``."""
    kw = dict(max_steps=BOUNCES, start_bias=ChandelierOnlyTrainer.START_BIAS,
              wall_frac=ChandelierOnlyTrainer.WALL_FRAC)
    if guide is not None:
        kw.update(guide=guide, guide_prob=T_GUIDE_PROB, guide_noise=0.1)
    out = []
    calls = recorded_launches(cuda_intersect, "nearest_hit", lambda: out.append(
        fb_walk.generate_trajectories(scene, draws, **kw)))
    return out[0], calls


class BranchTape:
    """The branches of the ReLUs and clamps (``torch.relu_``, ``clamp``,
    ``clamp_min``) one forward took: each site's input and the mask where
    its derivative is one.  Given another run's masks it takes those
    instead: the values stay this run's and the derivative is the other's,
    so a float64 gradient can follow the branches a float32 run took."""

    KINKS = {"relu_": lambda x: x > 0,
             "clamp": lambda x, lo, hi: (x >= lo) & (x <= hi),
             "clamp_min": lambda x, lo: x >= lo}

    def __init__(self, replay=None):
        self.replay, self.sites = replay, []

    def __enter__(self):
        self.real = {n: getattr(torch, n) for n in self.KINKS}
        for n, f in self.real.items():
            setattr(torch, n, self._tap(n, f))
        return self

    def __exit__(self, *exc):
        for n, f in self.real.items():
            setattr(torch, n, f)

    def _tap(self, name, real):
        def tapped(x, *bounds):
            i = len(self.sites)
            self.sites.append((name, x.detach().to("cpu", torch.float64,
                                                   copy=True),
                               self.KINKS[name](x, *bounds).cpu()))
            if self.replay is None:
                return real(x, *bounds)
            mask = self.replay[i][2].to(x.device, x.dtype)
            return real(x.detach().clone(), *bounds) + (x - x.detach()) * mask
        return tapped


def leaf_grads(agent):
    return {f"{part}.{n}": p.grad.detach().to("cpu", torch.float64)
            for part in ("encoder", "forward", "backward")
            for n, p in agent.nets[part].named_parameters()
            if p.grad is not None}


def worst_leaf(got, want):
    """``(leaf, value)``: the largest of max|got - want| over max|want|."""
    return max(((k, float((got[k] - w).abs().max())
                 / max(float(w.abs().max()), 1e-30)) for k, w in want.items()),
               key=lambda kv: kv[1])


def update_card_vs_cpu(dev, cfg, ckpt, batch):
    """One update step from the checkpoint ``ckpt`` (fresh Adam state) on
    ``batch`` on the card and on the CPU, each float32 gradient against the
    float64 gradient on the CPU through the same ReLU and clamp branches,
    and the card's Adam step against the same step in float64 from the
    card's gradient: ``(report, failures, the card's agent)``.  The report
    also holds each device's gradient against float64's own branches and
    the branches that differ (a float32 input on the other side of a kink
    from float64's)."""
    cpu = torch.device("cpu")
    b64 = tuple(torch.from_numpy(np.asarray(b, np.float64)) for b in batch)

    def f64_grads(replay=None):
        a = FBResearchAgent(cfg, seed=SEED, device=cpu)
        a.load(ckpt)
        for net in a.nets.values():
            net.double()
        with BranchTape(replay) as tape:
            total, _ = loss_terms(*a.nets.values(), b64, cfg)
        total.backward()
        return leaf_grads(a), tape.sites

    g64, sites64 = f64_grads()
    upd, failures, runs = {}, [], {}
    for name, d in (("card", dev), ("cpu", cpu)):
        a = FBResearchAgent(cfg, seed=SEED, device=d)
        a.load(ckpt)
        p0 = [p.detach().clone() for p in a.optimizer.param_groups[0][
            "params"]]
        with BranchTape() as tape:
            _, terms = a.update(batch)
        runs[name] = (a, p0, terms)
        check([s[0] for s in tape.sites] == [s[0] for s in sites64],
              f"update {name}: branch sites differ from float64's")
        g = leaf_grads(a)
        g_same, _ = f64_grads(tape.sites)
        flips, flip_x, act_err = {}, 0.0, 0.0
        for (fn, x, m), (_, x64, m64) in zip(tape.sites, sites64):
            scale = max(float(x64.abs().max()), 1e-30)
            act_err = max(act_err, float((x - x64).abs().max()) / scale)
            off = m != m64
            if off.any():
                flips[fn] = flips.get(fn, 0) + int(off.sum())
                flip_x = max(flip_x, float(x64[off].abs().max()) / scale)
        upd[name] = {"grad_vs_f64_same_branches": worst_leaf(g, g_same),
                     "grad_vs_f64": worst_leaf(g, g64),
                     "branches_differ": flips,
                     "branches_differ_largest_f64_input": flip_x,
                     "kink_inputs_vs_f64": act_err}
        if upd[name]["grad_vs_f64_same_branches"][1] > T_GRAD_TOL:
            failures.append(f"{name} gradient vs float64")
        if act_err > T_ACT_TOL:
            failures.append(f"{name} ReLU/clamp inputs vs float64")
    (card, p0, terms_c), (cpu_agent, _, terms_h) = runs["card"], runs["cpu"]
    upd["loss_terms_rel_err"] = max(
        abs(terms_c[k] - terms_h[k]) / max(abs(terms_h[k]), 1e-3)
        for k in terms_h)
    if upd["loss_terms_rel_err"] > T_LOSS_TOL:
        failures.append("loss terms card vs CPU")
    # The card's Adam step, and the same step in float64 from its gradient.
    got = [p.detach().to("cpu", torch.float64)
           for p in card.optimizer.param_groups[0]["params"]]
    ref = [p.detach().to("cpu", torch.float64).requires_grad_(True)
           for p in p0]
    for r, p in zip(ref, card.optimizer.param_groups[0]["params"]):
        if p.grad is not None:           # the attention's query and key
            r.grad = p.grad.detach().to("cpu", torch.float64)
    torch.optim.Adam(ref, lr=cfg.learning_rate, betas=(0.9, 0.999),
                     eps=1e-8).step()
    eps32 = torch.finfo(torch.float32).eps
    step_err = max(float(((g - r.detach()).abs()
                          / (eps32 * r.detach().abs()
                             + T_STEP_LR * cfg.learning_rate)).max())
                   for g, r in zip(got, ref))
    upd["adam_step_vs_f64_in_ulps"] = step_err
    if step_err > T_STEP_ULPS:
        failures.append("card Adam step vs float64")
    upd["params_over_1e-5_card_vs_cpu"] = sum(
        int(((p.detach().cpu() - q.detach()).abs() > 1e-5).sum())
        for p, q in zip(card.optimizer.param_groups[0]["params"],
                        cpu_agent.optimizer.param_groups[0]["params"]))
    return upd, failures, card


def fb_train_phase(dev, card, out_dir):
    """Phase fb_train: the FB learner's main path, ChandelierOnlyTrainer at
    its own config on the card (the walk's sweep the nearest-hit kernel,
    8 launches a scene; the render probe through the hybrid's level
    kernel), then its checks and times.  Returns ``(trainer, checkpoint,
    kernels entry)``."""
    t0 = time.perf_counter()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "torch.backends.cuda.matmul.allow_tf32 is on: TF32 matmuls")
    tr = ChandelierOnlyTrainer(num_training_scenes=T_SCENES + T_GUIDED_SCENES,
                               seed=SEED, device=dev, output_dir=out_dir)
    cfg = tr.config
    tr.agent.save(out_dir / "initial.npz")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t1 = time.perf_counter()
    tr.run_training(num_scenes=T_SCENES, scenes_per_batch=T_SCENES,
                    training_steps_per_scene=T_WALKERS)
    tr.guide_prob = T_GUIDE_PROB
    tr.probe_every = T_GUIDED_SCENES
    report = tr.run_training(num_scenes=T_GUIDED_SCENES,
                             scenes_per_batch=T_GUIDED_SCENES,
                             training_steps_per_scene=T_WALKERS,
                             scene_offset=T_SCENES)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launches = {"nearest_hit": cuda_intersect.nearest_hit.launches,
                "path_level": cuda_level.path_level.launches,
                "path_trace": cuda_path.path_trace.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    scenes = T_SCENES + T_GUIDED_SCENES
    agent = tr.agent
    check(launches["nearest_hit"] == BOUNCES * scenes,
          f"fb_train: {launches['nearest_hit']} nearest_hit launches, not "
          f"{BOUNCES} a scene")
    check(launches["path_level"] > 0, f"fb_train: the render probe launched "
          f"no level kernel ({launches})")
    check(agent.updates > 0 and np.isfinite(agent.losses).all(),
          f"fb_train: {agent.updates} updates, losses finite "
          f"{bool(np.isfinite(agent.losses).all())}")
    check(agent.light_memory, "fb_train: no light reached, no prototype")
    ckpt = out_dir / "fb_multi_scene_final.npz"

    # The walk: kernel sweep against nearest_hit_plain on the same draws,
    # unguided and with the trained agent in the loop.
    scene = tr.make_scene(scenes)[0]
    guide = agent.guide()
    equal, walk_err = {}, 0.0
    for name, g in (("unguided", None), ("guided", guide)):
        draws = fb_walk.draw_walk(
            T_WALKERS, scene.num_spheres, BOUNCES,
            start_bias=tr.START_BIAS, guided=g is not None,
            generator=torch.Generator(dev).manual_seed(SEED + 50), device=dev)
        got, calls = walk_sweep(scene, draws, g)
        kernel_hit = cuda_intersect.nearest_hit
        cuda_intersect.nearest_hit = cuda_intersect.nearest_hit_plain
        try:
            want, _ = walk_sweep(scene, draws, g)
        finally:
            cuda_intersect.nearest_hit = kernel_hit
        equal[name] = all(nan_equal(a, b) for a, b in zip(got, want))
        for args, kw, (t, _, found) in calls:
            tp, _, fp = cuda_intersect.nearest_hit_plain(*args, **kw)
            both = found & fp
            walk_err = max(walk_err, float((t - tp).abs().where(both, 0.0)
                                           .max()))
    check(all(equal.values()), f"fb_train: walk with the kernel sweep != "
          f"with nearest_hit_plain: {equal}")

    # One update step on the card and on the CPU, from the same parameters
    # with a fresh Adam state, on one batch of the trained agent's buffer,
    # from the initial parameters (as the CPU tests start) and from the
    # trained ones: each gradient against float64's through the same
    # branches, the card's Adam step against float64's (update_card_vs_cpu).
    batch = agent.buffer.sample(np.random.default_rng(SEED + 51),
                                cfg.batch_size)
    upd, upd_failed = {}, []
    for start, path in (("initial", out_dir / "initial.npz"),
                        ("trained", ckpt)):
        upd[start], failed, card_agent = update_card_vs_cpu(dev, cfg, path,
                                                            batch)
        upd_failed += [f"{start}: {f}" for f in failed]
    update_ms = cuda_ms(lambda: card_agent.update(batch), 20)

    # save_fb then load_fb: every tensor bit for bit.
    nets, _, extra = load_fb(ckpt, cfg)
    saved_equal = all(
        torch.equal(p.detach().cpu(), q)
        for name in PARTS for p, q in zip(agent.nets[name].parameters(),
                                          nets[name].parameters()))
    saved_equal &= extra["updates"] == agent.updates and len(
        extra["light_memory"]) == len(agent.light_memory)
    check(saved_equal, "fb_train: save_fb/load_fb round trip differs")

    # Times: a scene's walk (host clock, synchronised), its 8 sweep launches
    # replayed (device time queued behind a spin kernel, CUDA events around
    # the wrapper calls, the plain version), the sweep's bound on the walk's
    # rays (core/cuda_intersect.py::sweep_work).
    draws = fb_walk.draw_walk(T_WALKERS, scene.num_spheres, BOUNCES,
                              start_bias=tr.START_BIAS,
                              generator=torch.Generator(dev).manual_seed(
                                  SEED + 52), device=dev)
    walls = []
    for _ in range(5):
        t1 = time.perf_counter()
        walk_sweep(scene, draws)
        walls.append((time.perf_counter() - t1) * 1e3)
    _, calls = walk_sweep(scene, draws)

    def replay(fn=cuda_intersect.nearest_hit):
        for args, kw, _ in calls:
            fn(*args, **kw)

    replay()
    k_ms = cuda_ms(replay, 10)
    k_dev_ms = queued_ms(replay)
    k_plain_ms = cuda_ms(lambda: replay(cuda_intersect.nearest_hit_plain), 3)
    work, k_bytes = {}, 0
    for (lo, ld, sup, stable), kw, _ in calls:
        add_work(work, cuda_intersect.sweep_work(lo, ld, sup, stable))
        k_bytes += (W_BYTES_IN + W_BYTES_SUPPRESS + NH_BYTES_OUT) * lo.shape[0]
    k_ops = sweep_ops(work)[0]
    k_bound, k_by = bound(k_ops, k_bytes)

    t1 = time.perf_counter()
    held = tr.test_on_chandelier(num_tests=T_HELD_OUT)
    held_s = time.perf_counter() - t1
    stats = report["training_summary"]["agent_stats"]
    emit({"phase": "fb_train", **card,
          "trainer": "ChandelierOnlyTrainer", "config": {
              k: getattr(cfg, k) for k in ("z_dim", "e_hidden_dim",
                                           "f_hidden_dim", "b_hidden_dim",
                                           "batch_size", "update_freq",
                                           "max_bounces")},
          "scenes": scenes, "guided_scenes": T_GUIDED_SCENES,
          "guide_prob": T_GUIDE_PROB, "walkers_a_scene": T_WALKERS,
          "launches": launches, "train_seconds": train_s,
          "scenes_per_s": scenes / train_s,
          "updates": agent.updates, "updates_per_s": agent.updates / train_s,
          "buffer": agent.buffer.size, "light_hits": stats["performance"][
              "light_hits"], "light_memory": len(agent.light_memory),
          "loss_first": agent.losses[0], "loss_last": agent.losses[-1],
          "avg_hit_rate": report["performance_statistics"]["avg_hit_rate"],
          "render_probe": report["training_summary"].get(
              "render_probe_history"),
          "walk_kernel_vs_plain_bit_equal": equal,
          "walk_max_abs_t_err": walk_err,
          "update_card_vs_cpu": upd, "update_bounds": {
              "loss_terms": T_LOSS_TOL, "grad_vs_f64_same_branches":
              T_GRAD_TOL, "kink_inputs_vs_f64": T_ACT_TOL,
              "adam_step_vs_f64_in_ulps": T_STEP_ULPS},
          "save_load_bit_equal": saved_equal,
          "walk_wall_ms": walls, "walk_wall_ms_median": sorted(walls)[2],
          "sweep_launches_a_walk": len(calls),
          "sweep_device_ms_a_walk": k_dev_ms,
          "sweep_device_ms_a_launch": k_dev_ms / len(calls),
          "sweep_wrapper_ms_a_walk": k_ms, "sweep_plain_ms_a_walk": k_plain_ms,
          "sweep_bound_ms_a_walk": k_bound, "sweep_bound_by": k_by,
          "sweep_bound_ops": k_ops, "sweep_bound_bytes": k_bytes,
          "sweep_bound_share": k_bound / max(k_dev_ms, 1e-9),
          "sweep_work": work, "update_ms": update_ms,
          "held_out_chandelier": held, "held_out_seconds": held_s,
          "max_memory_allocated_bytes": peak, "library_ms": None,
          "seconds": time.perf_counter() - t0})
    check(not upd_failed, f"fb_train: update step: {upd_failed}: {upd}")
    # launches: the whole training run's; the times: one walk's launches.
    return tr, ckpt, {
        "name": "nearest_hit_walk", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/nearest_hit.cu",
        "replaces": "raytracer_tpu/core/pallas_intersect.py:42",
        "launches": launches["nearest_hit"], "launches_timed": len(calls),
        "max_abs_err": walk_err, "ms": k_dev_ms, "plain_ms": k_plain_ms, "bound_ms": k_bound,
        "bound_by": k_by, "library_ms": None}


def guided_obs_rows(scene, o, d, u, f, guide):
    """The observations of the guided rows of a hybrid trace on these draws
    (diffuse continuing lanes whose fb uniform is below fb_prob, level by
    level): ``[rows, 22]``."""
    seen = []

    def recording(obs):
        seen.append(obs.clone())
        return guide(obs)

    calls = recorded_launches(cuda_level, "path_level", lambda: trace_path(
        scene, o, d, max_bounces=BOUNCES, mirror_threshold=G_THRESHOLD,
        background=BG, uniforms=u, fb_uniforms=f, fb_prob=G_FB_PROB,
        guide_fn=recording, impl="hybrid"))
    check(len(calls) == len(seen) == BOUNCES,
          f"guided rows: {len(calls)} levels, {len(seen)} guide calls")
    rows = []
    for lvl, ((_, _, lv), obs) in enumerate(zip(calls, seen)):
        st = lv.state
        use = (((st & cuda_level.ST_CONT) != 0)
               & ((st & cuda_level.ST_MIRROR) == 0) & (f[lvl] < G_FB_PROB))
        rows.append(obs[use])
    return torch.cat(rows)


def fb_guide_dtypes_phase(dev, card, scene, params, cfg, ckpt):
    """Phase fb_guide_dtypes: the agent fb_train trained, as a guide in f32,
    bf16 and int8 through render_path(impl="hybrid") at bench.py's
    full-agent cell; the dtypes' actions on the frame's guided rows against
    f32's, the int8 guide on the card against its CPU twin, frame and guide
    times against each dtype's bound, hits against the traditional
    frame's.  Writes the far rows and a sample beside the checkpoint
    (``guided_rows.npz``, read by tests/int8_rows_vs_jax.py)."""
    t0 = time.perf_counter()
    agent = TrainedFBAgent(str(ckpt), scene, small_light_indices(scene),
                           params["camera_position"], config=cfg, seed=SEED,
                           device=dev)
    guides = {"float32": agent.as_guide_fn(),
              "bfloat16": agent.as_guide_fn(torch.bfloat16),
              "int8": agent.as_guide_fn("int8")}
    fkw = dict(width=A_W, height=A_H, spp=SPP, max_bounces=BOUNCES,
               fov=params["fov"], camera_position=params["camera_position"],
               mirror_threshold=G_THRESHOLD, background=BG, device=dev,
               impl="hybrid")

    def frame(g=None):
        kw = {} if g is None else dict(guide_fn=g, fb_prob=G_FB_PROB)
        out = render_path(scene, generator=torch.Generator(dev).manual_seed(
            SEED + 60), **fkw, **kw)
        torch.cuda.synchronize()
        return out

    _, trad = frame()
    trad = trad.as_dict()
    # The frame's guided rows, and each dtype's actions on them.
    gen = torch.Generator(dev).manual_seed(SEED + 61)
    jitter = torch.rand((SPP, A_H, A_W, 2), device=dev, generator=gen)
    o, d = perspective_rays(A_W, A_H, fov=params["fov"],
                            origin=params["camera_position"],
                            sample_xy=jitter)
    o = o.contiguous()
    R = o.shape[0]
    u = torch.rand((BOUNCES, R, 2), device=dev, generator=gen)
    f = torch.rand((BOUNCES, R), device=dev, generator=gen)
    rows = guided_obs_rows(scene, o, d, u, f, guides["float32"])
    ref = guides["float32"](rows)
    acts, diffs = {}, {}
    for name in ("bfloat16", "int8"):
        acts[name] = guides[name](rows)
        dd = (acts[name] - ref).abs()
        diffs[name] = {"max": float(dd.max()), "mean": float(dd.mean()),
                       "rows_at_or_over_max_bound": int(
                           (dd.amax(1) >= DTYPE_BOUNDS[name]["max"]).sum())}
    # The rows that hold JAX's own int8 guide to the same comparison
    # (tests/int8_rows_vs_jax.py): every row the int8 guide moves by 0.1 or
    # more, and a seeded sample of the others.
    far = (acts["int8"] - ref).abs().amax(1) >= 0.1
    pick = far | (torch.rand(rows.shape[0], generator=torch.Generator(
        dev).manual_seed(SEED + 63), device=dev) < 16384 / rows.shape[0])
    np.savez(ckpt.parent / "guided_rows.npz",
             rows=rows[pick].cpu().numpy(), f32=ref[pick].cpu().numpy(),
             bf16=acts["bfloat16"][pick].cpu().numpy(),
             int8=acts["int8"][pick].cpu().numpy(),
             proto=agent.light_prototype)
    # The int8 guide's products on the card (torch._int_mm, padded) against
    # its CPU twin's int32 products on the same int8 activations: exact
    # integers, so bit for bit, layer by layer, at a ragged row count and
    # at one below _int_mm's 17 rows.  Then the whole guide on the frame's
    # first 4,096 guided rows: a row whose int8 activations are the same on
    # both devices is within float rounding; where a 1-ulp difference
    # upstream rounded an activation to the next int8 level, the row is
    # within the CPU tests' bound.
    twin = quantize.Int8AgentApply(guides["int8"].qparams, cfg.z_dim, "cpu")
    gen = torch.Generator(dev).manual_seed(SEED + 62)
    products_equal = True
    for card_l, cpu_l in zip(guides["int8"].layers(), twin.layers()):
        for m in (4099, 5):
            qx = torch.randint(-127, 128, (m, card_l.k_in), generator=gen,
                               device=dev, dtype=torch.int8)
            products_equal &= bool(torch.equal(card_l.int_product(qx).cpu(),
                                               cpu_l.int_product(qx.cpu())))
    sub = rows[:4096]
    levels = {}
    for side, g in (("card", guides["int8"]), ("cpu", twin)):
        seen = levels[side] = []
        for layer in g.layers():
            def taped(qx, real=layer.int_product, seen=seen):
                seen.append(qx.cpu())
                return real(qx)
            layer.int_product = taped
    try:
        tw = (guides["int8"](sub).cpu() - twin(sub.cpu())).abs().amax(1)
    finally:
        for g in (guides["int8"], twin):
            for layer in g.layers():
                del layer.int_product
    moved = torch.stack([(a != b).any(1) for a, b in zip(levels["card"],
                                                         levels["cpu"])])
    same = ~moved.any(0)
    twin_err = {"max_same_levels": float(tw[same].max()) if same.any()
                else 0.0,
                "rows_other_levels": int((~same).sum()),
                "max_other_levels": float(tw.max()),
                "rows": int(tw.numel()), "int_products_bit_equal":
                products_equal, "layers": len(twin.layers())}
    row_flops = agent_guide_flops(cfg)
    peaks = {"float32": PEAK_F32_FLOPS, "bfloat16": PEAK_BF16,
             "int8": PEAK_INT8}
    out = {}
    for name, g in guides.items():
        img, st = frame(g)
        check(bool(torch.isfinite(img).all()) and st.as_dict()["fb_used"] > 0,
              f"fb_guide_dtypes {name}: {st.as_dict()}")
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            frame(g)
            walls.append((time.perf_counter() - t1) * 1e3)
        timed = TimedGuide(g)
        frame(timed)
        g_ms = timed.ms()
        g_bound = BOUNCES * R * row_flops / peaks[name] * 1e3
        st = st.as_dict()
        out[name] = {
            "frame_wall_ms": walls, "frame_wall_ms_median": sorted(walls)[1],
            "guide_ms": g_ms, "guide_calls": len(timed.events),
            "guide_bound_ms": g_bound, "guide_bound_rate": peaks[name],
            "guide_bound_share": g_bound / g_ms, "stats": st,
            "light_hits_over_traditional": st["light_hits"]
            / max(trad["light_hits"], 1),
            "small_light_hits_over_traditional": st["small_light_hits"]
            / max(trad["small_light_hits"], 1)}
    emit({"phase": "fb_guide_dtypes", **card,
          "frame": f"{A_W}x{A_H}@{SPP}spp/{BOUNCES}", "impl": "hybrid",
          "agent": f"trained by fb_train ({ckpt.name}), z {cfg.z_dim}, "
                   f"encoder {cfg.e_hidden_dim}, backward {cfg.b_hidden_dim}",
          "guided_rows": rows.shape[0], "vs_float32_on_guided_rows": diffs,
          "bounds_vs_float32": DTYPE_BOUNDS, "int8_card_vs_cpu": twin_err,
          "int8_card_vs_cpu_bounds": {"same_levels": INT8_SAME_LEVELS,
                                      "other_levels": INT8_MAX,
                                      "int_products": "bit equal"},
          "traditional_stats": trad, "guide_flops_per_row": row_flops,
          "dtypes": out, "seconds": time.perf_counter() - t0})
    for name, dd in diffs.items():
        check(dd["max"] < DTYPE_BOUNDS[name]["max"]
              and dd["mean"] < DTYPE_BOUNDS[name]["mean"],
              f"fb_guide_dtypes: {name} vs float32 on the guided rows {dd}")
    check(products_equal and twin_err["max_same_levels"] <= INT8_SAME_LEVELS
          and twin_err["max_other_levels"] <= INT8_MAX,
          f"fb_guide_dtypes: int8 card vs CPU {twin_err}")


class plain_sweep:
    """``with plain_sweep():`` every caller of ``cuda_intersect.
    nearest_hit`` sweeps with ``nearest_hit_plain`` (no launch)."""

    def __enter__(self):
        self.kernel = cuda_intersect.nearest_hit
        cuda_intersect.nearest_hit = cuda_intersect.nearest_hit_plain

    def __exit__(self, *exc):
        cuda_intersect.nearest_hit = self.kernel


def launch_counts():
    return {"path_trace": route_counts(),
            "path_level": cuda_level.path_level.launches,
            "nearest_hit": cuda_intersect.nearest_hit.launches,
            "whitted_trace": cuda_whitted.whitted_trace.launches,
            "whitted_shade": cuda_shade.whitted_shade.launches}


def add_launches(total, counts):
    """Sums ``launch_counts()`` dicts into ``total``."""
    for k, v in counts.items():
        if isinstance(v, dict):
            add_launches(total.setdefault(k, {}), v)
        else:
            total[k] = total.get(k, 0) + v
    return total


def sweep_entry(name, calls, err):
    """A ``kernels`` entry for the nearest-hit launches ``calls`` (as
    ``recorded_launches`` returns them), replayed: device ms queued behind a
    spin kernel, the plain version's ms, the bound from the sweep's work
    on these rays."""
    def replay(fn=cuda_intersect.nearest_hit):
        for args, kw, _ in calls:
            fn(*args, **kw)

    dev_ms = queued_ms(replay)
    plain_ms = cuda_ms(lambda: replay(cuda_intersect.nearest_hit_plain), 2)
    work, nbytes = {}, 0
    for (lo, ld, sup, stable), kw, _ in calls:
        add_work(work, cuda_intersect.sweep_work(lo, ld, sup, stable))
        nbytes += (W_BYTES_IN + NH_BYTES_OUT) * lo.shape[0]
    ops = sweep_ops(work)[0]
    b_ms, b_by = bound(ops, nbytes)
    return {"name": name, "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/nearest_hit.cu",
            "replaces": "raytracer_tpu/core/pallas_intersect.py:42",
            "launches_timed": len(calls), "max_abs_err": err, "ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_ops": ops, "bound_bytes": nbytes, "library_ms": None}


def sweep_vs_plain(calls):
    """The recorded nearest-hit ``calls`` against ``nearest_hit_plain`` on
    the same arguments: ``(max |t - t_plain| over hits, found and idx
    equal)``; ``found`` must be equal everywhere, ``idx`` where found."""
    err, same = 0.0, True
    for args, kw, (t, idx, found) in calls:
        tp, ip, fp = cuda_intersect.nearest_hit_plain(*args, **kw)
        same = (same and bool(torch.equal(found, fp))
                and bool(torch.equal(idx.long().where(found, -1),
                                     ip.long().where(fp, -1))))
        err = max(err, float((t - tp).abs().where(found & fp, 0.0).max()))
    return err, same


def plain_sides(scene, model, w, h, camera_position, dev):
    """The chandelier comparison's two sides through impl "plain" on the
    generators ``run_comparison`` seeds from ``SEED``: ``(traditional
    counts, guided counts)``."""
    trad_seed, fb_seed = side_seeds(SEED)
    rkw = dict(width=w, height=h, spp=SPP, max_bounces=BOUNCES,
               camera_position=camera_position, device=dev)
    _, tp = render_path(scene, mirror_threshold=0.0, impl="plain",
                        generator=torch.Generator(dev).manual_seed(
                            trad_seed), **rkw)
    guide = DistilledGuide.load(model).as_guide_fn()
    _, fp = render_path(scene, mirror_threshold=G_THRESHOLD,
                        guide_fn=guide, fb_prob=G_FB_PROB, impl="plain",
                        generator=torch.Generator(dev).manual_seed(
                            fb_seed), **rkw)
    return tp.as_dict(), fp.as_dict()


def sides_match(stats, tp, fp):
    """``(traditional counts equal plain's, guided hits within the dense
    student's bounds of plain's)``."""
    return (all(stats["traditional"][k] == tp[k] for k in C_COUNTS),
            all(hits_close(stats["fb"][k], fp[k])
                for k in ("light_hits", "small_light_hits")))


def compare_student_phase(dev, card, scene, params, out_dir, launches):
    """Phase compare_student: chandelier_comparison with the shipped
    student the registry routes to the camera, impl "kernel" on both sides,
    at the reference comparison (200x100) and the deployment frame
    (800x600), 8 spp, 8 bounces; each side against the same render through
    impl "plain" on the same generator (traditional: every count equal;
    guided: the dense bf16 student's bounds)."""
    for w, h in ((C_W, C_H), (W, H)):
        t0 = time.perf_counter()
        model = model_path_for("chandelier", w, h, STUDENTS_DIR)
        check(model is not None, f"no shipped student for {w}x{h}")
        reset_counts()
        stats = chandelier_comparison(
            model_path=model, width=w, height=h, samples_per_pixel=SPP,
            max_bounces=BOUNCES, impl="kernel", timing_iters=C_ITERS,
            out_dir=out_dir / f"student_{w}x{h}", device=dev)
        torch.cuda.synchronize()
        counts = launch_counts()
        add_launches(launches, counts)
        tp, fp = plain_sides(scene, model, w, h, params["camera_position"],
                             dev)
        trad_equal, fb_ok = sides_match(stats, tp, fp)
        emit({"phase": "compare_student", **card,
              "frame": f"{w}x{h}@{SPP}spp/{BOUNCES}",
              "model": str(Path(model).relative_to(ROOT)),
              "statistics": stats, "launches": counts,
              "traditional_plain_counts": tp,
              "traditional_equal_plain": trad_equal,
              "fb_plain_counts": fp, "fb_within_bounds_of_plain": fb_ok,
              "seconds": time.perf_counter() - t0})
        check(counts["path_trace"]["unguided"] == C_ITERS + 1
              and counts["path_trace"]["bf16_mma"] == C_ITERS + 1,
              f"compare_student {w}x{h}: launches {counts}")
        check(trad_equal, f"compare_student {w}x{h}: traditional counts "
              f"{stats['traditional']} != plain {tp}")
        check(fb_ok, f"compare_student {w}x{h}: guided counts "
              f"{stats['fb']} outside the bounds of plain {fp}")
        check(stats["fb"]["fb_used"] > 0, "compare_student: no guided bounce")


def compare_complex_phase(dev, card, out_dir, launches):
    """Phase compare_complex: complex_comparison with the shipped complex
    student, impl "kernel", 200x100@8spp/8; the traditional side (diffuse
    at 0.9) against plain within the diffuse bounds of diffuse_and_ragged,
    the guided side within the dense student's."""
    t0 = time.perf_counter()
    model = STUDENTS_DIR / "fb_complex_distilled.npz"
    reset_counts()
    stats = complex_comparison(model_path=str(model), width=C_W, height=C_H,
                               samples_per_pixel=SPP, max_bounces=BOUNCES,
                               impl="kernel", timing_iters=C_ITERS,
                               out_dir=out_dir / "complex", device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    add_launches(launches, counts)
    scene, _, _ = create_complex_scene(device=dev)
    trad_seed, fb_seed = side_seeds(SEED)
    rkw = dict(width=C_W, height=C_H, spp=SPP, max_bounces=BOUNCES,
               camera_position=create_camera_for_scene(), device=dev,
               mirror_threshold=G_THRESHOLD, impl="plain")
    _, tp = render_path(scene, generator=torch.Generator(dev).manual_seed(
        trad_seed), **rkw)
    _, fp = render_path(scene, guide_fn=DistilledGuide.load(model)
                        .as_guide_fn(), fb_prob=G_FB_PROB,
                        generator=torch.Generator(dev).manual_seed(fb_seed),
                        **rkw)
    tp, fp = tp.as_dict(), fp.as_dict()
    trad_ok = stats_close({k: stats["traditional"][k] for k in C_COUNTS[:3]},
                          {k: tp[k] for k in C_COUNTS[:3]}, 0.02)
    fb_ok = all(hits_close(stats["fb"][k], fp[k])
                for k in ("light_hits", "small_light_hits"))
    emit({"phase": "compare_complex", **card,
          "frame": f"{C_W}x{C_H}@{SPP}spp/{BOUNCES}",
          "model": str(model.relative_to(ROOT)), "statistics": stats,
          "launches": counts, "traditional_plain_counts": tp,
          "traditional_within_2pct_of_plain": trad_ok,
          "fb_plain_counts": fp, "fb_within_bounds_of_plain": fb_ok,
          "seconds": time.perf_counter() - t0})
    check(counts["path_trace"]["bf16_mma"] == C_ITERS + 1,
          f"compare_complex: launches {counts}")
    check(trad_ok and fb_ok, f"compare_complex: {stats} vs plain {tp}, {fp}")
    check(stats["fb"]["fb_used"] > 0, "compare_complex: no guided bounce")


def compare_agent_phase(dev, card, scene, params, ckpt, out_dir, launches):
    """Phase compare_agent: run_comparison with the agent fb_train trained
    (its checkpoint), impl "hybrid" then "stepwise" on both sides,
    200x100@8spp/8: every count equal across the two impls."""
    t0 = time.perf_counter()
    out, counts = {}, {}
    for impl in ("hybrid", "stepwise"):
        reset_counts()
        out[impl] = run_comparison(
            scene, camera_position=params["camera_position"], width=C_W,
            height=C_H, samples_per_pixel=SPP, max_bounces=BOUNCES,
            model_path=str(ckpt), impl=impl, scene_name="chandelier",
            out_dir=out_dir / f"agent_{impl}", device=dev)
        torch.cuda.synchronize()
        counts[impl] = launch_counts()
        add_launches(launches, counts[impl])
    keys = {"traditional": C_COUNTS, "fb": C_COUNTS + ("fb_used",
                                                       "fb_success")}
    equal = all(out["hybrid"][s][k] == out["stepwise"][s][k]
                for s, ks in keys.items() for k in ks)
    emit({"phase": "compare_agent", **card,
          "frame": f"{C_W}x{C_H}@{SPP}spp/{BOUNCES}",
          "model": str(ckpt.relative_to(ROOT)), "statistics": out,
          "launches": counts, "counts_equal_across_impls": equal,
          "seconds": time.perf_counter() - t0})
    renders = 2 * 2                      # warm-up and timed, both sides
    check(counts["hybrid"]["path_level"] == renders * BOUNCES
          and counts["stepwise"]["nearest_hit"] == renders * BOUNCES,
          f"compare_agent: launches {counts}")
    check(equal, "compare_agent: hybrid and stepwise counts differ")
    check(out["hybrid"]["fb"]["fb_used"] > 0, "compare_agent: no guided "
          "bounce")


def compare_chunked_phase(dev, card, scene, params, out_dir, launches):
    """Phase compare_chunked: the harness with spp_chunk=2 (the CLI's
    --spp-chunk, impl "kernel") at 800x600@8spp/8, then render_path with
    spp_chunk=2 against its four chunks rendered one by one on the same
    jitter (equal image and counts), and the peak memory of the chunked
    frame against the unchunked one."""
    t0 = time.perf_counter()
    model = model_path_for("chandelier", W, H, STUDENTS_DIR)
    reset_counts()
    stats = chandelier_comparison(
        model_path=model, width=W, height=H, samples_per_pixel=SPP,
        max_bounces=BOUNCES, impl="kernel", spp_chunk=C_CHUNK,
        out_dir=out_dir / "chunked", device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    add_launches(launches, counts)
    chunks = SPP // C_CHUNK
    kw = dict(width=W, height=H, max_bounces=BOUNCES, mirror_threshold=0.0,
              camera_position=params["camera_position"], device=dev)
    jitter = torch.rand((SPP, H, W, 2), device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED + 61))
    peaks = {}
    for name, chunk in (("unchunked", None), ("chunked", C_CHUNK)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        img, st = render_path(scene, spp=SPP, jitter=jitter, impl="kernel",
                              spp_chunk=chunk, **kw)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated(dev) - base
    total, chunk_stats = None, {}
    for c in range(chunks):
        o, d = perspective_rays(W, H, fov=params["fov"],
                                origin=params["camera_position"],
                                sample_xy=jitter[c * C_CHUNK:
                                                 (c + 1) * C_CHUNK])
        rgb, s = trace_path(scene, o, d, max_bounces=BOUNCES,
                            mirror_threshold=0.0, background=BG,
                            impl="kernel")
        sums = rgb.reshape(C_CHUNK, H, W, 3).sum(0)
        total = sums if total is None else total + sums
        add_work(chunk_stats, s.as_dict())
    want = torch.clamp_max(vec.div_scalar(torch.floor(
        vec.div_scalar(total, SPP)), 255.0), 1.0)
    equal = bool(torch.equal(img, want)) and st.as_dict() == chunk_stats
    emit({"phase": "compare_chunked", **card,
          "frame": f"{W}x{H}@{SPP}spp/{BOUNCES}", "spp_chunk": C_CHUNK,
          "statistics": stats, "launches": counts,
          "chunked_equals_sum_of_chunks": equal,
          "peak_bytes_above_start": peaks,
          "peak_ratio_chunked_to_unchunked":
              peaks["chunked"] / peaks["unchunked"],
          "seconds": time.perf_counter() - t0})
    check(counts["path_trace"]["unguided"] == chunks * 2
          and counts["path_trace"]["bf16_mma"] == chunks * 2,
          f"compare_chunked: launches {counts}")
    check(equal, "compare_chunked: the chunked frame != its chunks summed")
    check(peaks["chunked"] < peaks["unchunked"],
          f"compare_chunked: chunked peak {peaks}")


def distill_phase(dev, card, scene, params, ckpt, out_dir, launches):
    """Phase distill: distill_agent on the agent fb_train trained, the
    chandelier at its defaults (4 frames an aspect, 30 epochs, hidden 64,
    64, light-hit weights); the observation walk and the light-hit weights
    with the kernel sweep against nearest_hit_plain (equal); the student
    through compare_student's 200x100 comparison on the guided kernel.
    Returns the walk sweep's ``kernels`` entry."""
    t0 = time.perf_counter()
    cam = params["camera_position"]
    agent = TrainedFBAgent(str(ckpt), scene, small_light_indices(scene), cam,
                           device=dev)
    reset_counts()
    student, res = distill_agent(agent, scene, camera_position=cam)
    torch.cuda.synchronize()
    counts = launch_counts()
    add_launches(launches, counts)
    path = out_dir / "fb_chandelier_distilled_card.npz"
    student.save(path)

    # One frame of the observation walk at 2:1, kernel and plain sweeps.
    teacher = agent.as_guide_fn(dtype=None)
    wkw = dict(width=128, height=64, frames=1, camera_position=cam,
               device=dev)

    def walk():
        return distill.collect_observations(
            scene, teacher, generator=torch.Generator(dev).manual_seed(
                SEED + 62), **wkw)

    walk_out = []
    calls = recorded_launches(cuda_intersect, "nearest_hit",
                              lambda: walk_out.append(walk()))
    with plain_sweep():
        obs_p = walk()
    obs_k = walk_out[0]
    walk_equal = bool(np.array_equal(obs_k, obs_p))
    acts = np.clip(distill._chunked(teacher, obs_k, dev), -1.0, 1.0)
    w_k = distill.light_hit_weights(scene, obs_k, acts, device=dev)
    with plain_sweep():
        w_p = distill.light_hit_weights(scene, obs_k, acts, device=dev)
    weights_equal = bool(np.array_equal(w_k, w_p))
    # One shooting launch at the main path's chunk (distill._chunked's
    # 1 << 19 rows), the walk's observations and teacher actions tiled.
    rows = 1 << 19
    shoot_obs = np.resize(obs_k, (rows, obs_k.shape[1]))
    shoot_acts = np.resize(acts, (rows, acts.shape[1]))
    shots = []
    calls += recorded_launches(
        cuda_intersect, "nearest_hit", lambda: shots.append(
            distill.light_hit_weights(scene, shoot_obs, shoot_acts,
                                      device=dev)))
    with plain_sweep():
        shots_p = distill.light_hit_weights(scene, shoot_obs, shoot_acts,
                                            device=dev)
    weights_equal = weights_equal and bool(np.array_equal(shots[0], shots_p))
    err, hits_equal = sweep_vs_plain(calls)
    entry = sweep_entry("nearest_hit_distill", calls, err)
    entry["launches"] = counts["nearest_hit"]

    reset_counts()
    stats = chandelier_comparison(
        model_path=str(path), width=C_W, height=C_H, samples_per_pixel=SPP,
        max_bounces=BOUNCES, impl="kernel", out_dir=out_dir / "distilled",
        device=dev)
    torch.cuda.synchronize()
    c2 = launch_counts()
    add_launches(launches, c2)
    tp, fp = plain_sides(scene, str(path), C_W, C_H, cam, dev)
    trad_equal, fb_ok = sides_match(stats, tp, fp)
    emit({"phase": "distill", **card, "teacher": str(ckpt.relative_to(ROOT)),
          "hidden": list(student.hidden), "observations": res.n_obs,
          "observations_collected": res.n_obs // 2,
          "seconds_by_stage": res.seconds, "steps": res.steps,
          "steps_per_s": res.steps / res.seconds["train"],
          "final_loss": res.final_loss, "launches": counts,
          "walk_kernel_vs_plain_bit_equal": walk_equal,
          "light_hit_weights_kernel_vs_plain_equal": weights_equal,
          "light_hit_rows": int((w_k > 1).sum()),
          "sweep_found_idx_equal_plain": hits_equal,
          "walk_sweep": entry, "student_comparison": stats,
          "student_comparison_launches": c2,
          "student_traditional_plain_counts": tp,
          "student_traditional_equal_plain": trad_equal,
          "student_fb_plain_counts": fp,
          "student_fb_within_bounds_of_plain": fb_ok,
          "seconds": time.perf_counter() - t0})
    check(np.isfinite(res.final_loss) and res.steps > 0,
          f"distill: loss {res.final_loss}, {res.steps} steps")
    check(counts["nearest_hit"] >= 2 * 4 * BOUNCES,
          f"distill: {counts['nearest_hit']} nearest_hit launches")
    check(walk_equal, "distill: the walk with the kernel sweep != plain")
    check(weights_equal, "distill: light_hit_weights kernel != plain")
    check(hits_equal, "distill: the sweep's found or idx != plain's")
    check(c2["path_trace"]["bf16_mma"] == 2,
          f"distill: the student took no tensor-core launch: {c2}")
    check(trad_equal, f"distill: traditional counts {stats['traditional']} "
          f"!= plain {tp}")
    check(fb_ok, f"distill: the student's counts {stats['fb']} outside the "
          f"bounds of plain {fp}")
    return entry


def output5_phase(dev, card, out_dir, launches):
    """Phase output5: trace_output5 for the three methods at the
    experiment's fast_mode grid (201x201, 3 bounces), the kernel sweep
    against the plain sweep on the same planes (equal image and stats),
    frame ms; then CustomSceneExperiment("fast_mode") end to end.  Returns
    the sweep's ``kernels`` entry (one traditional frame's launches)."""
    t0 = time.perf_counter()
    cfg = CONFIG_MODES[O5_MODE]
    scene, _, _, _ = library.custom_scene(device=dev)
    o, d, h, w = grid_rays(100, 0.01, cfg["multiple"], origin=(0, 0, 1),
                           device=dev)
    L = cfg["max_bounces"]
    methods, counts, entry = {}, {}, None
    for method in O5_METHODS:
        u, g = draw_planes(method, L, o.shape[0],
                           torch.Generator(dev).manual_seed(SEED + 63), dev)
        kw = dict(max_bounces=L, method=method, uniforms=u,
                  glass_uniforms=g)
        reset_counts()
        rk, sk = trace_output5(scene, o, d, impl="kernel", **kw)
        torch.cuda.synchronize()
        counts[method] = launch_counts()
        add_launches(launches, counts[method])
        rp, sp = trace_output5(scene, o, d, impl="plain", **kw)
        sk = {k: float(v) for k, v in sk.items()}
        sp = {k: float(v) for k, v in sp.items()}
        equal = bool(torch.equal(rk, rp)) and sk == sp
        ms = cuda_ms(lambda: trace_output5(scene, o, d, impl="kernel", **kw),
                     5)
        plain_ms = cuda_ms(lambda: trace_output5(scene, o, d, impl="plain",
                                                 **kw), 2)
        methods[method] = {"stats": sk, "kernel_vs_plain_bit_equal": equal,
                           "frame_ms": ms, "plain_sweep_frame_ms": plain_ms,
                           "finite": bool(torch.isfinite(rk).all())}
        check(equal and methods[method]["finite"],
              f"output5 {method}: kernel sweep != plain sweep ({sk}, {sp})")
        check(counts[method]["nearest_hit"] == L,
              f"output5 {method}: launches {counts[method]}")
        if entry is None:
            calls = recorded_launches(
                cuda_intersect, "nearest_hit",
                lambda: trace_output5(scene, o, d, impl="kernel", **kw))
            err, hits_equal = sweep_vs_plain(calls)
            check(hits_equal, f"output5 {method}: the sweep's found or idx "
                  f"!= plain's")
            entry = sweep_entry("nearest_hit_output5", calls, err)
            entry["found_idx_equal_plain"] = hits_equal
    exp_dir = out_dir / "experiment"
    reset_counts()
    t1 = time.perf_counter()
    exp = CustomSceneExperiment(output_dir=exp_dir, mode=O5_MODE,
                                device=dev)
    results = exp.run_custom_scene_experiment()
    exp_s = time.perf_counter() - t1
    c_exp = launch_counts()
    add_launches(launches, c_exp)
    entry["launches"] = sum(c["nearest_hit"] for c in counts.values()) \
        + c_exp["nearest_hit"]
    grid = exp.output_dir / "unified_comparison.png"
    emit({"phase": "output5", **card, "grid": f"{w}x{h}", "bounces": L,
          "methods": methods, "launches": counts,
          "experiment": {"mode": O5_MODE, "seconds": exp_s,
                         "launches": c_exp,
                         "results": json.loads(results.read_text()),
                         "grid_png": grid.exists()},
          "seconds": time.perf_counter() - t0})
    check(c_exp["whitted_trace"] >= 1 and c_exp["nearest_hit"] > 0,
          f"output5 experiment: launches {c_exp}")
    check(grid.exists(), "output5 experiment: no unified_comparison.png")
    return entry


def whitted_entry(name, calls, err):
    """A ``kernels`` entry for the Whitted-kernel launches ``calls`` (as
    ``recorded_launches`` returns them), replayed: device ms queued behind
    a spin kernel, the plain version's ms, the bound from the work the
    plain version counts on these rays."""
    def replay(fn=None):
        for args, kw, _ in calls:
            (fn or cuda_whitted.whitted_trace)(*args, **kw)

    dev_ms = queued_ms(replay)
    plain_ms = cuda_ms(lambda: replay(cuda_whitted.whitted_trace_plain), 2)
    ops = nbytes = 0
    for (o, d, sup, table), kw, _ in calls:
        work = {}
        cuda_whitted.whitted_trace_plain(o, d, sup, table, counters=work,
                                         **kw)
        ops += sweep_ops(work)[0] + whitted_rest_ops(work, o.shape[0])
        nbytes += (W_BYTES_IN + (0 if sup is None else W_BYTES_SUPPRESS)
                   + W_BYTES_OUT) * o.shape[0]
    b_ms, b_by = bound(ops, nbytes)
    return {"name": name, "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/whitted_trace.cu",
            "replaces": "raytracer_tpu/core/pallas_whitted.py:110",
            "launches_timed": len(calls), "max_abs_err": err, "ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_ops": ops, "bound_bytes": nbytes, "library_ms": None}


def whitted_vs_plain(calls):
    """The recorded Whitted-kernel ``calls`` against the plain version on
    the same arguments: ``(bit_equal, max |float diff|)``."""
    equal, err = True, 0.0
    for args, kw, res in calls:
        eq, e, _ = compare_traces(res, cuda_whitted.whitted_trace_plain(
            *args, **kw))
        equal, err = equal and eq, max(err, e)
    return equal, err


def nearest_hit_calls(fn):
    """``fn()`` with every nearest-hit launch of the Whitted level loop
    (``cuda_whitted``'s binding) recorded; the shading sweeps inside its
    own kernel."""
    return recorded_launches(cuda_whitted, "nearest_hit", fn)


def rl_env(impl, dev):
    scene, gl, pl = training_scene_complete(device=dev)
    return RayTracerEnv(scene, image_width=RL_W, image_height=RL_H,
                        fov=RL_FOV, max_bounces=RL_BOUNCES, global_lights=gl,
                        point_lights=pl, variant="rl", impl=impl)


def rl_env_phase(dev, card, launches):
    """Phase rl_env: 2,048 episodes of the RL env at the shipped
    configuration through the kernel route (the Whitted kernel at reset,
    the nearest-hit kernel a level, the shading kernel) and through
    the plain route on the same draws: obs, rewards, done flags and totals
    bit for bit.  Returns the ``kernels`` entries of the reset's Whitted
    launch and of one step's nearest-hit launches."""
    t0 = time.perf_counter()
    env_k, env_p = rl_env("kernel", dev), rl_env("plain", dev)
    gen = torch.Generator(dev).manual_seed(SEED + 70)
    pixel = env_k.draw_pixels(RL_EPISODES, gen)
    acts = random_actions(env_k, RL_EPISODES, gen)

    def episodes(env):
        s, o = env.reset(RL_EPISODES, pixel=pixel)
        outs, steps = [o], []
        for a in acts:
            t1 = time.perf_counter()
            s, o, r, term, info = env.step(s, a)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t1) * 1e3)
            outs += [o, r, term, info["truncated"], s.total_reward]
        return outs, steps

    episodes(env_k)                                  # warm-up
    reset_counts()
    t1 = time.perf_counter()
    outs_k, step_ms = episodes(env_k)
    wall_k = time.perf_counter() - t1
    counts = launch_counts()
    add_launches(launches, counts)
    t1 = time.perf_counter()
    outs_p, plain_step_ms = episodes(env_p)
    wall_p = time.perf_counter() - t1
    equal = all(bool(torch.equal(a, b)) for a, b in zip(outs_k, outs_p))
    steps = len(acts)
    # The kernels on this route, recorded and replayed: the reset's one
    # Whitted launch and the first step's nearest-hit launches.
    w_calls = recorded_launches(cuda_whitted, "whitted_trace",
                                lambda: env_k.reset(RL_EPISODES,
                                                    pixel=pixel))
    w_equal, w_err = whitted_vs_plain(w_calls)
    s0, _ = env_k.reset(RL_EPISODES, pixel=pixel)
    nh_calls = nearest_hit_calls(lambda: env_k.step(s0, acts[0]))
    nh_err, nh_equal = sweep_vs_plain(nh_calls)
    w_entry = whitted_entry("whitted_trace_rl_reset", w_calls, w_err)
    nh_entry = sweep_entry("nearest_hit_rl_step", nh_calls, nh_err)
    w_entry["launches"] = counts["whitted_trace"]
    nh_entry["launches"] = counts["nearest_hit"]
    nh_entry["step_wall_ms"] = step_ms[0]
    emit({"phase": "rl_env", **card,
          "env": f"training_scene_complete {RL_W}x{RL_H} fov {RL_FOV}, "
                 f"{RL_BOUNCES} bounces, rl",
          "episodes": RL_EPISODES, "steps": steps,
          "kernel_vs_plain_bit_equal": equal, "launches": counts,
          "reset_whitted_bit_equal": w_equal,
          "step_sweeps_found_idx_equal": nh_equal,
          "kernel_wall_s": wall_k, "plain_wall_s": wall_p,
          "kernel_step_wall_ms": step_ms, "plain_step_wall_ms": plain_step_ms,
          "episode_steps_per_s": RL_EPISODES * steps / wall_k,
          "total_reward_mean": float(outs_k[-1].mean()),
          "seconds": time.perf_counter() - t0})
    check(equal, "rl_env: the kernel route differs from the plain route")
    check(w_equal and nh_equal, "rl_env: a recorded kernel call differs "
          "from its plain version")
    check(counts["whitted_trace"] == 1 and counts["nearest_hit"] >= steps
          and counts["whitted_shade"] >= steps, f"rl_env: launches {counts}")
    return [w_entry, nh_entry]


def rl_eval_phase(dev, card, launches):
    """Phase rl_eval: the shipped PPO (compare_rl_vs_random, 2,048
    episodes a side) and the shipped SAC (evaluate_policy) through the
    kernel route."""
    t0 = time.perf_counter()
    env = rl_env("kernel", dev)
    ppo = load_policy(SHIPPED_DIR / "ppo_raytracer.npz", env)
    sac = load_policy(SHIPPED_DIR / "sac_raytracer.npz", env, algo="sac")
    reset_counts()
    t1 = time.perf_counter()
    cmp = compare_rl_vs_random(env, ppo.predict, episodes=RL_EPISODES,
                               seed=SEED)
    torch.cuda.synchronize()
    ppo_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    sac_res = evaluate_policy(env, sac.predict, episodes=RL_EPISODES,
                              seed=SEED)
    torch.cuda.synchronize()
    sac_s = time.perf_counter() - t1
    counts = launch_counts()
    add_launches(launches, counts)
    rl, rnd = cmp["rl"], cmp["random"]

    def sigma(p):
        return (p * (1 - p) / RL_EPISODES) ** 0.5

    ppo_ok = abs(rl["light_hit_rate"] - RL_PPO_HITS) \
        <= RL_SIGMAS * sigma(RL_PPO_HITS)
    rnd_ok = abs(rnd["light_hit_rate"] - RL_RANDOM_HITS) \
        <= RL_SIGMAS * sigma(RL_RANDOM_HITS)
    emit({"phase": "rl_eval", **card, "episodes": RL_EPISODES,
          "ppo": {"hidden": list(ppo.cfg.hidden),
                  "light_hit_rate": rl["light_hit_rate"],
                  "avg_reward": rl["avg_reward"],
                  "avg_bounces": rl["avg_bounces"],
                  "recorded_light_hit_rate": RL_PPO_HITS,
                  "bound": RL_SIGMAS * sigma(RL_PPO_HITS),
                  "within_bound": ppo_ok},
          "random": {"light_hit_rate": rnd["light_hit_rate"],
                     "avg_reward": rnd["avg_reward"],
                     "avg_bounces": rnd["avg_bounces"],
                     "recorded_light_hit_rate": RL_RANDOM_HITS,
                     "bound": RL_SIGMAS * sigma(RL_RANDOM_HITS),
                     "within_bound": rnd_ok},
          "rays_per_light_hit": cmp["rays_per_light_hit"],
          "sac": {"hidden": list(sac.cfg.hidden),
                  "light_hit_rate": sac_res["light_hit_rate"],
                  "avg_reward": sac_res["avg_reward"],
                  "avg_bounces": sac_res["avg_bounces"]},
          "ppo_and_random_s": ppo_s, "sac_s": sac_s, "launches": counts,
          "seconds": time.perf_counter() - t0})
    check(ppo_ok and rnd_ok, "rl_eval: a light-hit rate outside 4 sigma "
          "of its recorded value")
    check(rl["light_hit_rate"] > rnd["light_hit_rate"],
          "rl_eval: the shipped PPO does not beat random actions")
    check(sac_res["light_hit_rate"] > rnd["light_hit_rate"] * 1.05
          and sac_res["avg_reward"] > rnd["avg_reward"] * 1.5,
          "rl_eval: the shipped SAC misses the JAX package's pin")


def f64_adam_step(params0, grads, lr):
    """One Adam step (optax's settings) in float64 on the CPU from
    ``params0`` with ``grads``."""
    ref = [p.detach().to("cpu", torch.float64).requires_grad_(True)
           for p in params0]
    for r, g in zip(ref, grads):
        r.grad = g.detach().to("cpu", torch.float64)
    torch.optim.Adam(ref, lr=lr, betas=(0.9, 0.999), eps=1e-8).step()
    return [r.detach() for r in ref]


def step_ulps(got, want, lr):
    eps32 = torch.finfo(torch.float32).eps
    return max(float(((g.detach().to("cpu", torch.float64) - w).abs()
                      / (eps32 * w.abs() + T_STEP_LR * lr)).max())
               for g, w in zip(got, want))


def grad_vs(got, want):
    """Largest over leaves of max|got - want| over max|want|."""
    return max(float((g.detach().to("cpu", torch.float64) - w).abs().max())
               / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def f64_module(module):
    return copy.deepcopy(module).to("cpu", torch.float64)


def rl_train_phase(dev, card, launches):
    """Phase rl_train: PPO at the shipped configuration from its seeded
    weights, the first minibatch's gradient against float64's on the CPU
    and the card's Adam step (after optax's clip) against the same step in
    float64, then RL_PPO_ITERS iterations (ms a rollout, ms an update);
    SAC from the shipped weights, the first update's critic and actor
    gradients against float64's (the card's target and noise) and its
    Adam steps against float64's, then RL_SAC_ITERS iterations of the
    device ring buffer with RL_SAC_UPDATES updates each."""
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "rl_train: TF32 matmuls are on")
    env = rl_env("kernel", dev)
    cpu = torch.device("cpu")
    report, failures = {}, []
    reset_counts()
    # PPO: the first minibatch held against float64.
    ppo = PPOTrainer(env, PPOConfig(hidden=(128, 128), batch_envs=512,
                                    ent_coef=0.01), seed=SEED)
    recs, last, _ = ppo.rollout(*ppo.rollout_draws())
    data = ppo.prepare(recs, last)
    perm = ppo.update_draws()[0]
    mbatch = tuple(x[perm[:data[0].shape[0] // ppo.cfg.minibatches]]
                   for x in data)
    params = list(ppo.net.parameters())
    p0 = [p.detach().clone() for p in params]
    ppo.opt.zero_grad(set_to_none=True)
    loss, _ = ppo.loss(mbatch)
    loss.backward()
    g_card = [p.grad.detach().clone() for p in params]
    net64 = f64_module(ppo.net)
    ppo64 = PPOTrainer.__new__(PPOTrainer)
    ppo64.net, ppo64.cfg = net64, ppo.cfg
    loss64, _ = PPOTrainer.loss(ppo64, tuple(
        x.to(cpu, torch.float64) for x in mbatch))
    loss64.backward()
    clip_by_global_norm_(params, ppo.cfg.max_grad_norm)
    ppo.opt.step()
    want = f64_adam_step(p0, [p.grad for p in params], ppo.cfg.learning_rate)
    report["ppo"] = {
        "loss_rel_err": abs(float(loss.detach()) - float(loss64.detach()))
        / max(abs(float(loss64.detach())), 1e-3),
        "grad_vs_f64": grad_vs(g_card, [p.grad for p in
                                        net64.parameters()]),
        "adam_step_vs_f64_in_ulps": step_ulps(params, want,
                                              ppo.cfg.learning_rate)}
    # PPO iterations, timed by part.
    rollout_ms, update_ms = [], []
    for _ in range(RL_PPO_ITERS):
        t1 = time.perf_counter()
        recs, last, ep = ppo.rollout(*ppo.rollout_draws())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss_i = ppo.update(recs, last, ppo.update_draws())
        torch.cuda.synchronize()
        rollout_ms.append((t2 - t1) * 1e3)
        update_ms.append((time.perf_counter() - t2) * 1e3)
    report["ppo"].update(rollout_ms=rollout_ms, update_ms=update_ms,
                         iteration_ms=[a + b for a, b in
                                       zip(rollout_ms, update_ms)],
                         final_loss=loss_i, mean_episode_reward=float(
                             ep.mean()))

    # SAC: the first update held against float64.
    sac = SACTrainer(env, SACConfig(batch_envs=128, batch_size=256,
                                    learning_starts=0), seed=SEED)
    sac.load(SHIPPED_DIR / "sac_raytracer.npz")
    flat, _ = sac._ring_rollout(explore=False)
    idx = torch.randint(0, flat[0].shape[0], (sac.cfg.batch_size,),
                        generator=sac.generator, device=dev)
    batch = tuple(x[idx] for x in flat[:5])
    n1, n2 = sac.update_draws(sac.cfg.batch_size)
    obs, action, reward, next_obs, done = batch
    alpha = torch.exp(sac.log_alpha.detach())
    with torch.no_grad():
        na, nlp = sac.sample_action(next_obs, n1)
        tq1, tq2 = sac.target_critic(next_obs, na)
        target = reward + sac.cfg.gamma * (1 - done) * (
            torch.minimum(tq1, tq2) - alpha * nlp)
    a0 = [p.detach().clone() for p in sac.actor.parameters()]
    c0 = [p.detach().clone() for p in sac.critic.parameters()]
    critic64, actor64 = f64_module(sac.critic), f64_module(sac.actor)
    sac.update(batch, n1, n2)
    lr = sac.cfg.learning_rate
    b64 = [x.to(cpu, torch.float64) for x in batch]
    q1, q2 = critic64(b64[0], b64[1])
    t64 = target.to(cpu, torch.float64)
    ((q1 - t64) ** 2 + (q2 - t64) ** 2).mean().backward()
    critic1_64 = f64_module(sac.critic)              # the updated critic
    sac64 = SACTrainer.__new__(SACTrainer)
    sac64.actor = actor64
    sac64.mid = sac.mid.to(cpu, torch.float64)
    sac64.scale = sac.scale.to(cpu, torch.float64)
    a, logp = sac64.sample_action(b64[0], n2.to(cpu, torch.float64))
    q1, q2 = critic1_64(b64[0], a)
    (alpha.to(cpu, torch.float64) * logp
     - torch.minimum(q1, q2)).mean().backward()
    report["sac"] = {
        "critic_grad_vs_f64": grad_vs(
            [p.grad for p in sac.critic.parameters()],
            [p.grad for p in critic64.parameters()]),
        "actor_grad_vs_f64": grad_vs(
            [p.grad for p in sac.actor.parameters()],
            [p.grad for p in actor64.parameters()]),
        "critic_adam_step_vs_f64_in_ulps": step_ulps(
            list(sac.critic.parameters()), f64_adam_step(
                c0, [p.grad for p in sac.critic.parameters()], lr), lr),
        "actor_adam_step_vs_f64_in_ulps": step_ulps(
            list(sac.actor.parameters()), f64_adam_step(
                a0, [p.grad for p in sac.actor.parameters()], lr), lr)}
    # SAC with the ring buffer on the card, and one update's time.
    out = sac.train_on_device(
        RL_SAC_ITERS * (RL_BOUNCES + 2) * sac.cfg.batch_envs,
        iters_per_dispatch=RL_SAC_ITERS, updates_per_rollout=RL_SAC_UPDATES)
    sac_batch = (*batch, torch.ones_like(batch[2]))
    update_ms = cuda_ms(lambda: sac.update(
        sac_batch, *sac.update_draws(sac.cfg.batch_size), weighted=True), 20)
    report["sac"].update(train_on_device=out, update_ms=update_ms,
                         updates=RL_SAC_ITERS * RL_SAC_UPDATES + 1)
    counts = launch_counts()
    add_launches(launches, counts)
    for algo, keys in (("ppo", ("grad_vs_f64",)),
                       ("sac", ("critic_grad_vs_f64", "actor_grad_vs_f64"))):
        for k in keys:
            if report[algo][k] > T_GRAD_TOL:
                failures.append(f"{algo} {k}")
        for k, v in report[algo].items():
            if k.endswith("in_ulps") and v > T_STEP_ULPS:
                failures.append(f"{algo} {k}")
    if report["ppo"]["loss_rel_err"] > T_LOSS_TOL:
        failures.append("ppo loss vs float64")
    emit({"phase": "rl_train", **card, "launches": counts, **report,
          "bounds": {"grad": T_GRAD_TOL, "adam_step_ulps": T_STEP_ULPS,
                     "loss": T_LOSS_TOL},
          "seconds": time.perf_counter() - t0})
    check(not failures, f"rl_train: {failures}")
    check(np.isfinite(out["critic_loss"]) and out["total_steps"] > 0,
          f"rl_train: SAC on the card {out}")


def rl_render_phase(dev, card, launches):
    """Phase rl_render: render_guided at 400x300@1spp, 5 bounces, with the
    shipped PPO and with uniform draws, through the Whitted kernel (three
    launches a bounce) and the plain route: the images bit for bit.
    Returns the ``kernels`` entry of a uniform frame's Whitted launches."""
    t0 = time.perf_counter()
    scene = rl_renderer.create_test_scene(dev)
    env = RayTracerEnv(scene, image_width=RL_W, image_height=RL_H, fov=90,
                       max_bounces=RL_RENDER_BOUNCES, variant="rl")
    ppo = load_policy(SHIPPED_DIR / "ppo_raytracer.npz", env)
    u = rl_renderer.draw_uniforms(1, RL_RENDER_BOUNCES, RL_W * RL_H,
                                  torch.Generator(dev).manual_seed(SEED + 80),
                                  dev)
    kw = dict(width=RL_W, height=RL_H, max_bounces=RL_RENDER_BOUNCES)
    sides, entry = {}, None
    for name, policy, planes in (("ppo", ppo.predict, None),
                                 ("uniform", None, u)):
        def frame(impl, policy=policy, planes=planes):
            return rl_renderer.render_guided(scene, policy, planes,
                                             impl=impl, **kw)
        frame("kernel")
        reset_counts()
        img_k = frame("kernel")
        torch.cuda.synchronize()
        counts = launch_counts()
        add_launches(launches, counts)
        img_p = frame("plain")
        walls = []
        for impl in ("kernel", "plain", "kernel"):
            t1 = time.perf_counter()
            frame(impl)
            torch.cuda.synchronize()
            walls.append(((time.perf_counter() - t1) * 1e3, impl))
        sides[name] = {
            "bit_equal": bool(torch.equal(img_k, img_p)),
            "launches": counts,
            "frame_ms": min(w for w, i in walls if i == "kernel"),
            "plain_frame_ms": min(w for w, i in walls if i == "plain"),
            "mean_pixel": float(img_k.mean()),
            "finite": bool(torch.isfinite(img_k).all())}
        if planes is not None:
            calls = recorded_launches(cuda_whitted, "whitted_trace",
                                      lambda: frame("kernel"))
            w_equal, w_err = whitted_vs_plain(calls)
            entry = whitted_entry("whitted_trace_rl_render", calls, w_err)
            sides[name]["recorded_calls_bit_equal"] = w_equal
    entry["launches"] = sum(v["launches"]["whitted_trace"]
                            for v in sides.values())
    emit({"phase": "rl_render", **card,
          "frame": f"{RL_W}x{RL_H}@1spp/{RL_RENDER_BOUNCES}", **sides,
          "seconds": time.perf_counter() - t0})
    for name, v in sides.items():
        check(v["bit_equal"] and v["finite"],
              f"rl_render {name}: kernel image != plain image")
        check(v["launches"]["whitted_trace"] >= 3,
              f"rl_render {name}: launches {v['launches']}")
    check(sides["uniform"]["recorded_calls_bit_equal"],
          "rl_render: a recorded Whitted call differs from plain")
    return entry


# --- Frame-serving extras: turntables, compact Whitted, sharded renders,
# --- the reference .pth import and the CLI's animate. ----------------------

TT_FRAMES, TT_W, TT_H = 24, 400, 300         # README.md:137-142, planets2
AP_FRAMES, AP_W, AP_H, AP_SPP, AP_BOUNCES = 12, 200, 100, 4, 8
CB_SCENE, CB_W, CB_H = "cornell_box:1007", 160, 120     # the showcase's
CB_CAMERA = (0.0, 0.5, 0.0)        # the CLI's camera for template scenes


def wall_ms(fn, reps=3):
    """Least host milliseconds of ``fn()`` ended by a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t1) * 1e3)
    return best


def animate_whitted_phase(dev, card, launches):
    """Phase animate_whitted: README's planets2 turntable (24 frames,
    400x300, the CLI's orbit around scene_focus) through
    render_whitted_frames: frame 0 equals the single-frame kernel render
    bit for bit, a frame's kernel route its plain route.  Returns the
    ``kernels`` entries of one frame's Whitted and shading launches."""
    t0 = time.perf_counter()
    scene, gl, pl, p = library.planets2_scene(device=dev)
    eyes, target, radius, y = animation.turntable(
        scene, p["camera_position"], TT_FRAMES, device=dev)
    o, d = animation.camera_path_rays(eyes, target, TT_W, TT_H)
    kw = dict(max_bounces=p["max_bounces"], background=p["background"],
              miss_colour=p.get("sky_colour"))

    def frames():
        return animation.render_whitted_frames(scene, gl, pl, o, d, TT_H,
                                               TT_W, **kw)

    frames()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    imgs = frames()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    add_launches(launches.setdefault("animate_whitted", {}), counts)
    ms = wall_ms(frames) / TT_FRAMES
    one = lambda impl, f=0: render_whitted(  # noqa: E731
        scene, gl, pl, o[f].contiguous(), d[f].contiguous(), TT_H, TT_W,
        impl=impl, **kw)
    single_equal = bool(torch.equal(imgs[0], one("kernel")))
    k = TT_FRAMES // 3
    plain_equal, plain_err, plain_off = compare_images(imgs[k], one("plain",
                                                                    k))
    w_calls = recorded_launches(cuda_whitted, "whitted_trace",
                                lambda: one("kernel", k))
    w_equal, w_err = whitted_vs_plain(w_calls)
    s_calls = recorded_launches(cuda_shade, "whitted_shade",
                                lambda: one("kernel", k))
    s_entry = shade_entry("whitted_shade_animate", s_calls)
    emit({"phase": "animate_whitted", **card,
          "frames": f"{TT_FRAMES} x {TT_W}x{TT_H}/{p['max_bounces']}",
          "target": [float(v) for v in target], "radius": radius, "y": y,
          "launches": counts,
          "launches_a_frame": {n: counts[n] / TT_FRAMES
                               for n in ("whitted_trace", "nearest_hit",
                                         "whitted_shade")},
          "ms_a_frame": ms, "max_memory_allocated_bytes": peak,
          "frame0_equals_single_frame": single_equal,
          "frame_kernel_vs_plain_bit_equal": plain_equal,
          "frame_kernel_vs_plain_max_abs_err": plain_err,
          "recorded_whitted_bit_equal": w_equal,
          "recorded_shade_bit_equal": s_entry["bit_equal"],
          "mean_pixel": float(imgs.mean()),
          "seconds": time.perf_counter() - t0})
    check(tuple(imgs.shape) == (TT_FRAMES, TT_H, TT_W, 3)
          and bool(torch.isfinite(imgs).all()), "animate_whitted: frames")
    check(not torch.equal(imgs[0], imgs[k]), "animate_whitted: no motion")
    check(single_equal, "animate_whitted: frame 0 != its single-frame render")
    check(plain_equal or plain_off <= W_PIXELS_OFF,
          f"animate_whitted: kernel vs plain {plain_err}, {plain_off} off")
    check(w_equal and s_entry["bit_equal"], "animate_whitted: a recorded "
          "launch differs from its plain version")
    check(counts["whitted_trace"] == counts["whitted_shade"] == TT_FRAMES
          and counts["nearest_hit"] == 0,
          f"animate_whitted: launches {counts}")
    w_entry = whitted_entry("whitted_trace_animate", w_calls, w_err)
    w_entry["launches"] = counts["whitted_trace"]
    s_entry["launches"] = counts["whitted_shade"]
    return [w_entry, s_entry]


def animate_path_phase(dev, card, launches):
    """Phase animate_path: README's guided chandelier turntable (12 frames,
    200x100@4spp/8, the registry's bf16 student), the same turntable
    unguided, and cornell_box:1007 at 160x120@4/8 with the registry's
    cornell student, through render_path_frames impl "kernel"; frame 0's
    trace held against plain on the same draws (unguided bit for bit,
    guided within the dense-bf16 bounds)."""
    t0 = time.perf_counter()
    chand, _, _, cp = chandelier_scene(device=dev)
    cornell, _ = generate_scene(CB_SCENE.split(":")[0],
                                int(CB_SCENE.split(":")[1]), device=dev)
    runs = {
        "chandelier_guided": (chand, cp["camera_position"], AP_W, AP_H,
                              guide_for("chandelier", AP_W, AP_H,
                                        STUDENTS_DIR)),
        "chandelier_unguided": (chand, cp["camera_position"], AP_W, AP_H,
                                None),
        "cornell_guided": (cornell, CB_CAMERA, CB_W, CB_H,
                           guide_for(CB_SCENE, CB_W, CB_H, STUDENTS_DIR)),
    }
    out = {}
    for name, (scene, cam, w, h, guide) in runs.items():
        check(guide is not None or "unguided" in name,
              f"animate_path {name}: the registry found no student")
        eyes, target, _, _ = animation.turntable(scene, cam, AP_FRAMES,
                                                 device=dev)
        kw = dict(width=w, height=h, spp=AP_SPP, max_bounces=AP_BOUNCES,
                  guide_fn=guide, fb_prob=1.0, device=dev)

        def frames(impl="kernel", e=eyes):
            return animation.render_path_frames(
                scene, e, target, impl=impl,
                generator=torch.Generator(dev).manual_seed(SEED + 90), **kw)

        frames()
        reset_counts()
        imgs, st = frames()
        torch.cuda.synchronize()
        counts = launch_counts()
        add_launches(launches.setdefault("animate_path", {}), counts)
        ms = wall_ms(frames) / AP_FRAMES
        # Frame 0's trace, kernel vs plain on the same draws.
        g = torch.Generator(dev).manual_seed(SEED + 91)
        R = AP_SPP * h * w
        jit = torch.rand((AP_SPP, h, w, 2), generator=g, device=dev)
        u = torch.rand((AP_BOUNCES, R, 2), generator=g, device=dev)
        fb = (torch.rand((AP_BOUNCES, R), generator=g, device=dev)
              if guide is not None else None)
        o0, d0 = animation.look_at_rays(w, h, eye=eyes[0], target=target,
                                        sample_xy=jit)
        tkw = dict(max_bounces=AP_BOUNCES, background=BG, uniforms=u,
                   fb_uniforms=fb, guide_fn=guide, fb_prob=1.0)
        rk, sk = trace_path(scene, o0, d0, impl="kernel", **tkw)
        rp, sp = trace_path(scene, o0, d0, impl="plain", **tkw)
        ok, rep = compare_guided(rk, sk.as_dict(), rp, sp.as_dict(),
                                 exact=guide is None)
        # The frames path's frame 0 is that trace.
        f0, _ = animation.render_path_frames(
            scene, eyes[:1], target, jitter=jit[None], uniforms=u[None],
            fb_uniforms=None if fb is None else fb[None], impl="kernel",
            **kw)
        same_f0 = bool(torch.equal(f0[0], path_renderer._average(
            rk.reshape(AP_SPP, h, w, 3).sum(0), AP_SPP)))
        out[name] = {"frames": f"{AP_FRAMES} x {w}x{h}@{AP_SPP}spp/"
                               f"{AP_BOUNCES}",
                     "launches": counts, "ms_a_frame": ms,
                     "stats": st.as_dict(), "kernel_vs_plain": rep,
                     "frame0_is_its_trace": same_f0,
                     "finite": bool(torch.isfinite(imgs).all())}
        check(ok and same_f0 and out[name]["finite"],
              f"animate_path {name}: {rep}, frame 0 {same_f0}")
        route = "unguided" if guide is None else "bf16_mma"
        check(counts["path_trace"][route] == AP_FRAMES,
              f"animate_path {name}: launches {counts}")
    hits = {n: out[n]["stats"]["small_light_hits"] for n in out}
    emit({"phase": "animate_path", **card, **out,
          "small_light_hits": hits,
          "guided_over_unguided": (hits["chandelier_guided"]
                                   / max(hits["chandelier_unguided"], 1)),
          "seconds": time.perf_counter() - t0})


def compact_profile(frame, log_dir):
    """One compact frame under ``utils/profiling.py::device_trace`` (its
    Chrome trace into ``log_dir``): the window on the host clock, the
    device's busy time from the kernels' own events, the host reads (each
    a ``_local_scalar_dense``, ``nonzero`` or device-to-host copy, which
    waits for the card) and device time by kernel."""
    frame()
    torch.cuda.synchronize()
    with device_trace(str(log_dir)) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_name, reads = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
        elif e.name in ("aten::_local_scalar_dense", "aten::nonzero"):
            reads += 1
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"window_ms": window_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / window_ms,
            "host_reads": reads, "device_kernels": sum(
                c for c, _ in by_name.values()),
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, (c, us) in top]}


def whitted_compact_phase(dev, card, launches, trace_dir):
    """Phase whitted_compact: planets2 2001x2001@10 and marbles4 801x801@8
    through render_whitted(impl="compact") and trace_whitted: image and
    every trace field equal to the plain route bit for bit; the times of
    compact, kernel and plain, and a profile of one compact frame.
    Returns the ``kernels`` entry of planets2's compact sweeps."""
    entry = None
    for name, multiple in (("planets2", 10), ("marbles4", 4)):
        t0 = time.perf_counter()
        scene, gl, pl, o, d, h, w, kw, _ = notebook_frame(name, multiple, dev)
        eg, em = material_flags(scene)
        render_whitted(scene, gl, pl, o, d, h, w, impl="compact", **kw)
        reset_counts()
        img_c = render_whitted(scene, gl, pl, o, d, h, w, impl="compact",
                               **kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        add_launches(launches.setdefault("whitted_compact", {}), counts)
        img_p = render_whitted(scene, gl, pl, o, d, h, w, impl="plain", **kw)
        tkw = dict(enable_glass=eg, enable_mirror=em)
        res_c = trace_whitted(scene, o, d, kw["max_bounces"], impl="compact",
                              **tkw)
        res_p = trace_whitted(scene, o, d, kw["max_bounces"], impl="plain",
                              **tkw)
        tr_equal, tr_err, _ = compare_traces(res_c, res_p)
        # The levels' sweeps, recorded, with the live lanes a level.
        work = {}
        table = cuda_intersect.sphere_table(scene, eg, em)
        calls = recorded_launches(
            cuda_whitted, "nearest_hit",
            lambda: cuda_whitted.whitted_trace_compact(
                o, d.contiguous(), None, table,
                max_bounces=kw["max_bounces"], sweep="kernel",
                counters=work))
        ms = {impl: wall_ms(lambda i=impl: render_whitted(
            scene, gl, pl, o, d, h, w, impl=i, **kw), 2)
            for impl in ("compact", "kernel", "plain")}
        emit({"phase": "whitted_compact", **card, "scene": name,
              "frame": f"{w}x{h}/{kw['max_bounces']}", "launches": counts,
              "image_bit_equal": bool(torch.equal(img_c, img_p)),
              "trace_bit_equal": tr_equal, "trace_max_abs_err": tr_err,
              "live_lanes_and_bucket_a_level": work["lanes"],
              "frame_ms": ms,
              "profile": compact_profile(
                  lambda: render_whitted(scene, gl, pl, o, d, h, w,
                                         impl="compact", **kw),
                  trace_dir / name),
              "seconds": time.perf_counter() - t0})
        check(bool(torch.equal(img_c, img_p)) and tr_equal,
              f"whitted_compact {name}: compact != plain ({tr_err})")
        check(counts["whitted_trace"] == 0 and counts["whitted_shade"] == 1
              and counts["nearest_hit"] == len(work["lanes"]),
              f"whitted_compact {name}: launches {counts}")
        if name == "planets2":
            err, same = sweep_vs_plain(calls)
            check(same, "whitted_compact: a level's sweep differs from plain")
            entry = sweep_entry("nearest_hit_compact", calls, err)
            entry["launches"] = counts["nearest_hit"]
    return entry


def sharded_phase(dev, card, launches):
    """Phase sharded: make_mesh() on the one card (dp=1) and
    devices=[cuda:0]*2 (dp=2): the Whitted frame (true_original 601x601, a
    ray count dp=2 pads), the Whitted frames (5, padded to 6), the path
    frame (chandelier 200x100@4spp/8, impl "kernel") and the stepwise
    frame, each equal to its unsharded render bit for bit."""
    t0 = time.perf_counter()
    scene, gl, pl, o, d, h, w, kw, _ = notebook_frame("true_original", 3,
                                                      dev)
    planets, pgl, ppl, pp = library.planets2_scene(device=dev)
    eyes, target, _, _ = animation.turntable(planets, pp["camera_position"],
                                             5, device=dev)
    fo, fd = animation.camera_path_rays(eyes, target, 200, 150)
    fkw = dict(max_bounces=pp["max_bounces"], background=pp["background"])
    chand, _, _, cp = chandelier_scene(device=dev)
    g = torch.Generator(dev).manual_seed(SEED + 95)
    R = AP_SPP * AP_H * AP_W
    planes = dict(jitter=torch.rand((AP_SPP, AP_H, AP_W, 2), generator=g,
                                    device=dev),
                  uniforms=torch.rand((AP_BOUNCES, R, 2), generator=g,
                                      device=dev))
    pkw = dict(width=AP_W, height=AP_H, spp=AP_SPP, max_bounces=AP_BOUNCES,
               camera_position=cp["camera_position"], background=BG)
    want = {"whitted": render_whitted(scene, gl, pl, o, d, h, w, **kw),
            "whitted_frames": animation.render_whitted_frames(
                planets, pgl, ppl, fo, fd, 150, 200, **fkw)}
    for impl in ("kernel", "stepwise"):
        want[impl] = render_path(chand, impl=impl, device=dev, **planes,
                                 **pkw)
    out = {}
    reset_counts()
    for label, m in (("dp1", pmesh.make_mesh()),
                     ("dp2", pmesh.make_mesh(devices=[dev, dev]))):
        got = {"whitted": pmesh.render_whitted_sharded(m, scene, gl, pl, o,
                                                       d, h, w, **kw),
               "whitted_frames": pmesh.render_whitted_frames_sharded(
                   m, planets, pgl, ppl, fo, fd, 150, 200, **fkw)}
        for impl in ("kernel", "stepwise"):
            got[impl] = pmesh.render_path_sharded(m, chand, impl=impl,
                                                  **planes, **pkw)
        eq = {}
        for k, v in want.items():
            if isinstance(v, tuple):
                eq[k] = (bool(torch.equal(got[k][0], v[0]))
                         and got[k][1].as_dict() == v[1].as_dict())
            else:
                eq[k] = bool(torch.equal(got[k], v))
        out[label] = {"mesh": m.shape, "equal": eq}
    torch.cuda.synchronize()
    counts = launch_counts()
    add_launches(launches.setdefault("sharded", {}), counts)
    emit({"phase": "sharded", **card, **out, "launches": counts,
          "whitted_rays": h * w,
          "seconds": time.perf_counter() - t0})
    for label, v in out.items():
        check(all(v["equal"].values()),
              f"sharded {label}: a sharded render differs: {v['equal']}")


def reference_fb_state(cfg, seed, dev):
    """The reference's Enhanced FB state dicts (its key names,
    FB/fb_vs_traditional_complex.py:37-142) at ``cfg``'s widths, seeded
    weights at the scale of torch's initialisation, on the CPU."""
    g = torch.Generator(dev).manual_seed(seed)
    e, f, b, z, a = (cfg.e_hidden_dim, cfg.f_hidden_dim, cfg.b_hidden_dim,
                     cfg.z_dim, cfg.action_dim)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def lin(out, inp, name):
        return {f"{name}.weight": rand(out, inp) / inp ** 0.5,
                f"{name}.bias": rand(out) * 0.1}

    def ln(dim, name):
        return {f"{name}.weight": 1 + 0.1 * rand(dim),
                f"{name}.bias": 0.1 * rand(dim)}

    def res(dim, name):
        return {**lin(dim, dim, f"{name}.net.0"), **ln(dim, f"{name}.net.1"),
                **lin(dim, dim, f"{name}.net.3"), **ln(dim, f"{name}.net.4")}

    enc = {**lin(e, cfg.obs_dim, "input_proj.0"), **ln(e, "input_proj.1"),
           "attention.in_proj_weight": rand(3 * e, e) / e ** 0.5,
           "attention.in_proj_bias": rand(3 * e) * 0.1,
           **lin(e, e, "attention.out_proj"), **lin(e, e, "output.0"),
           **lin(2 * z, e, "output.2")}
    for i in range(3):
        enc.update(res(e, f"res_blocks.{i}"))
    fwd = {**lin(f, z + a, "input_net.0"), **ln(f, "input_net.1")}
    for i in range(cfg.num_layers):
        fwd.update(lin(2 * f, f, f"gated_blocks.{i}.0"))
    for h in range(cfg.num_forward_heads):
        fwd.update({**lin(f, f, f"heads.{h}.0"),
                    **lin(2 * z, f, f"heads.{h}.2")})
    bwd = {**lin(b, 2 * z, "input_net.0"), **ln(b, "input_net.1"),
           **lin(a, b, "mean_head"), **lin(a, b, "log_var_head")}
    for i in range(2):
        bwd.update(res(b, f"res_blocks.{i}"))
    return {k: {n: t.cpu() for n, t in sd.items()} for k, sd in
            (("encoder", enc), ("forward_model", fwd),
             ("backward_model", bwd))}


def imported_as_reference(ref, agent, cfg, dev):
    """Each checked parameter of ``agent`` (imported from the state dicts
    ``ref``) held on the card against the reference layout, restated here
    from torch's conventions: a ``Linear``'s kernel is ``weight.T``, a
    ``LayerNorm``'s scale its ``weight``, and ``in_proj_weight [3H, H]``
    the query, key and value kernels stacked as ``[H, heads, head_dim]``
    transposed.  Returns ``{checked name: equal}``."""
    e, heads = cfg.e_hidden_dim, 4
    enc, fwd, bwd = (ref[k] for k in ("encoder", "forward_model",
                                      "backward_model"))
    mha = agent.encoder.MultiHeadDotProductAttention_0
    last = cfg.num_layers + 2 * cfg.num_forward_heads
    pairs = {
        "enc.input_proj.0": (agent.encoder.Dense_0.kernel,
                             enc["input_proj.0.weight"].T),
        "enc.input_proj.1": (agent.encoder.LayerNorm_0.scale,
                             enc["input_proj.1.weight"]),
        "enc.output.2": (agent.encoder.Dense_2.bias, enc["output.2.bias"]),
        "enc.res_blocks.2.net.4": (
            agent.encoder.ResidualBlock_2.LayerNorm_1.scale,
            enc["res_blocks.2.net.4.weight"]),
        "enc.attention.out_proj": (
            mha.out.kernel.reshape(e, e),
            enc["attention.out_proj.weight"].T),
        "fwd.input_net.0": (agent.forward_model.Dense_0.kernel,
                            fwd["input_net.0.weight"].T),
        f"fwd.heads.{cfg.num_forward_heads - 1}.2": (
            getattr(agent.forward_model, f"Dense_{last}").kernel,
            fwd[f"heads.{cfg.num_forward_heads - 1}.2.weight"].T),
        "bwd.mean_head": (agent.backward.Dense_1.kernel,
                          bwd["mean_head.weight"].T),
        "bwd.log_var_head": (agent.backward.Dense_2.bias,
                             bwd["log_var_head.bias"]),
        "bwd.res_blocks.1.net.3": (
            agent.backward.ResidualBlock_1.Dense_1.kernel,
            bwd["res_blocks.1.net.3.weight"].T)}
    w_in = enc["attention.in_proj_weight"]
    for i, part in enumerate(("query", "key", "value")):
        pairs[f"enc.attention.in_proj.{part}"] = (
            getattr(mha, part).kernel,
            w_in[i * e:(i + 1) * e].T.reshape(e, heads, e // heads))
    return {k: bool(torch.equal(got, want.to(dev)))
            for k, (got, want) in pairs.items()}


def pth_import_phase(dev, card, scene, params, out_dir):
    """Phase pth_import: a reference-schema .pth at FBConfig()'s widths
    (seeded; its config an object of a class of the reference's
    fb_ray_tracing module, present only while it is written) loaded
    through TrainedFBAgent guides the 200x100@8spp/8 hybrid frame as the
    same weights saved as a native .npz do, bit for bit, and its imported
    parameters equal the reference layout restated from torch's
    conventions (``imported_as_reference``)."""
    t0 = time.perf_counter()
    cfg = FBConfig()
    out_dir.mkdir(parents=True, exist_ok=True)
    pth, npz = out_dir / "fb_reference.pth", out_dir / "fb_reference.npz"
    mod = types.ModuleType("fb_ray_tracing")
    mod.FBConfig = type("FBConfig", (), {"__module__": "fb_ray_tracing"})
    ref = reference_fb_state(cfg, SEED + 97, dev)
    sys.modules["fb_ray_tracing"] = mod
    try:
        torch.save({"fb_learner_state": ref, "config": mod.FBConfig()}, pth)
    finally:
        del sys.modules["fb_ray_tracing"]
    idx = small_light_indices(scene)
    cam = params["camera_position"]
    a_pth = TrainedFBAgent(str(pth), scene, idx, cam, config=cfg, device=dev)
    leaked = "fb_ray_tracing" in sys.modules
    as_reference = imported_as_reference(ref, a_pth, cfg, dev)
    nets = {"encoder": a_pth.encoder, "forward": a_pth.forward_model,
            "backward": a_pth.backward, "target_encoder": a_pth.encoder}
    save_fb(npz, nets, cfg)
    a_npz = TrainedFBAgent(str(npz), scene, idx, cam, config=cfg,
                           device=dev)
    rkw = dict(width=A_W, height=A_H, spp=SPP,
               max_bounces=BOUNCES, camera_position=cam,
               mirror_threshold=G_THRESHOLD, fb_prob=G_FB_PROB,
               impl="hybrid", device=dev)
    sides = [render_path(scene, guide_fn=a.as_guide_fn(),
                         generator=torch.Generator(dev).manual_seed(SEED),
                         **rkw) for a in (a_pth, a_npz)]
    torch.cuda.synchronize()
    equal = (bool(torch.equal(sides[0][0], sides[1][0]))
             and sides[0][1].as_dict() == sides[1][1].as_dict())
    params_equal = all(
        torch.equal(p, q) for n in ("encoder", "backward")
        for p, q in zip(getattr(a_pth, n).parameters(),
                        getattr(a_npz, n).parameters()))
    emit({"phase": "pth_import", **card,
          "frame": f"{A_W}x{A_H}@{SPP}spp/{BOUNCES}",
          "pth_bytes": pth.stat().st_size, "frame_bit_equal": equal,
          "parameters_equal": params_equal,
          "imported_as_reference": as_reference,
          "fb_ray_tracing_in_sys_modules": leaked,
          "stats": sides[0][1].as_dict(),
          "seconds": time.perf_counter() - t0})
    check(equal and params_equal and not leaked,
          "pth_import: the .pth agent does not guide as its .npz twin")
    check(all(as_reference.values()),
          f"pth_import: imported parameters differ from the reference "
          f"layout: {as_reference}")
    check(sides[0][1].as_dict()["fb_used"] > 0, "pth_import: no guided ray")


def cli_animate_phase(dev, card, out_dir):
    """Phase cli_animate: the CLI's animate, end to end on the card (the
    README's planets2 turntable), into ``out_dir``."""
    t0 = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    cli.main(["animate", "--scene", "planets2", "--frames", str(TT_FRAMES),
              "--width", str(TT_W), "--height", str(TT_H), "--out-dir",
              str(out_dir)])
    files = sorted(p.name for p in out_dir.iterdir())
    stats = json.loads((out_dir / "animation_stats.json").read_text())
    emit({"phase": "cli_animate", **card, "files": len(files),
          "stats": stats, "seconds": time.perf_counter() - t0})
    check(stats["frames"] == TT_FRAMES and len(files) == TT_FRAMES + 3,
          f"cli_animate: {len(files)} files, stats {stats}")


def level_edges_phase(dev):
    """Phase level_edges: on seeded scenes built to cross the shared level's
    rewrites (radii with T(r) != fl(r*r) and rays grazing them, lights whose
    cut passes through the hit points, grazing normals), the unguided path
    kernel against its plain version (bit for bit at mirror_threshold 0,
    exact and fast; at 0.9 the diffuse bound of diffuse_and_ragged), the
    level kernel against its plain version level by level on the same
    inputs, and the hybrid against the whole-trace kernel, bit for bit."""
    t0 = time.perf_counter()
    cells, ok = [], True
    for seed in EDGE_SEEDS:
        scene, o, d = level_edges.edge_scene(seed, EDGE_RAYS, dev)
        R = o.shape[0]
        spec, em = scene_spec(scene), emissive_indices(scene)
        gen = torch.Generator(dev).manual_seed(seed)
        u9 = torch.rand((BOUNCES, R, 2), device=dev, generator=gen)
        for thr, fast, u in ((0.0, False, None), (0.0, True, None),
                             (0.9, False, u9)):
            table = cuda_path.path_table(spec, em, thr, dev)
            kw = dict(max_bounces=BOUNCES, background=BG, fast=fast)
            rk, ck = cuda_path.path_trace(o, d, u, table, **kw)
            rp, cp = cuda_path.path_trace_plain(o, d, u, table, **kw)
            levels_equal = []

            def checked(lo, ld, lrun, lu, ltable, **lkw):
                a = cuda_level.path_level(lo, ld, lrun, lu, ltable, **lkw)
                b = cuda_level.path_level_plain(lo, ld, lrun, lu, ltable,
                                                **lkw)
                levels_equal.append(all(
                    (x is None and y is None) or bool(torch.equal(x, y))
                    for x, y in zip(a, b)))
                return a

            rh, ch = cuda_path.trace_levels(checked, o, d, u, table, **kw)
            torch.cuda.synchronize()
            equal = bool(torch.equal(rk, rp)) and bool(torch.equal(ck, cp))
            frac = float((rk == rp).all(-1).double().mean())
            sums_k = ck.sum(0, dtype=torch.int64).tolist()
            sums_p = cp.sum(0, dtype=torch.int64).tolist()
            hybrid_equal = (bool(torch.equal(rh, rk))
                            and bool(torch.equal(ch, ck)))
            # The first level's tests on the rewrites' edges.
            dn = torch.stack(vec.normalise_safe_c(*d.unbind(1)), -1)
            lv = cuda_level.path_level_plain(
                o, dn, torch.ones(R, dtype=torch.bool, device=dev),
                None if u is None else u[0], table, fast=fast,
                want_hit=True)
            edges = level_edges.edge_counts(
                o, dn, table, lv.hit, (lv.state & cuda_level.ST_CONT) != 0)
            cell_ok = (all(levels_equal) and len(levels_equal) == BOUNCES
                       and hybrid_equal and all(v > 0 for v in
                                                edges.values())
                       and (equal if thr == 0.0 else (
                           frac >= 0.95 and stats_close(
                               dict(enumerate(sums_k)),
                               dict(enumerate(sums_p)), 0.02))))
            ok &= cell_ok
            cells.append({"seed": seed, "mirror_threshold": thr,
                          "precision": "fast" if fast else "exact",
                          "rays": R, "kernel_vs_plain_bit_equal": equal,
                          "samples_equal_fraction": frac,
                          "counts_kernel": sums_k, "counts_plain": sums_p,
                          "levels_bit_equal": levels_equal,
                          "hybrid_vs_kernel_bit_equal": hybrid_equal,
                          "first_level_edges": edges, "ok": cell_ok})
    emit({"phase": "level_edges", "cells": cells,
          "seconds": time.perf_counter() - t0})
    check(ok, "level_edges: a kernel differs from its plain version, the "
          "hybrid from the kernel, or a scene crosses no edge: "
          f"{[c for c in cells if not c['ok']]}")


# --- The rest of the RL track (the shaped env, the curriculum), the CLI's
# --- interactive menu, the recipes and the figures. ------------------------

@contextlib.contextmanager
def in_dir(path):
    """Work in ``path`` (made afresh) and come back."""
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    here = os.getcwd()
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(here)


def shaped_episode(env, pixel, act_fn):
    """One shaped episode of ``env`` on ``pixel``, each step's action from
    ``act_fn(t, state, obs)``: the actions and, per call, the outputs
    (obs; then obs, reward, terminated, done, both counters, total
    reward)."""
    s, o = env.reset(pixel.shape[0], pixel=pixel)
    outs, acts = [o], []
    for t in range(env.max_bounces + 2):
        a = act_fn(t, s, o)
        s, o, r, term, _ = env.step(s, a)
        acts.append(a)
        outs += [o, r, term, s.done, s.consecutive_light_hits,
                 s.total_light_hits, s.total_reward]
    return acts, outs


def rl_shaped_phase(dev, card, launches):
    """Phase rl_shaped: the shaped env (agents/adaptive.py) at
    ppo_train_to_win's env over 2,048 episodes, one with the shipped PPO's
    actions and one with uniform actions, through the kernel route (the
    Whitted kernel at reset, the nearest-hit kernel a level of each step)
    and the plain route on the same actions: obs, rewards, done flags,
    counters and totals bit for bit.  A third episode takes light-seeking
    actions (tools/shaping_edges.py) so that finished lanes rest on lights.
    The count of each shaping term that fired; a shaped and a base step's
    ms (CUDA events: a step reads the card once a level, so its launches
    cannot queue behind a spin kernel) and the step's nearest-hit launches
    replayed with queued_ms."""
    t0 = time.perf_counter()
    env_k = AdaptiveRewardRayTracerEnv(rl_env("kernel", dev), (99, 100))
    env_p = AdaptiveRewardRayTracerEnv(rl_env("plain", dev), (99, 100))
    ppo = load_policy(SHIPPED_DIR / "ppo_raytracer.npz", env_k.env)
    gen = torch.Generator(dev).manual_seed(SEED + 90)
    pixel = env_k.draw_pixels(RL_EPISODES, gen)
    uniform = random_actions(env_k.env, RL_EPISODES, gen)
    kinds = {
        "ppo": lambda t, s, o: ppo.predict(o),
        "uniform": lambda t, s, o: uniform[t],
        "light_seeking": lambda t, s, o: light_seeking_actions(
            env_k, s, uniform[t])[0]}
    report, equal_all, terms_all = {}, True, dict.fromkeys(SHAPING_TERMS, 0)
    counts = {}
    for kind, act_fn in kinds.items():
        reset_counts()
        acts, outs_k = shaped_episode(env_k, pixel, act_fn)
        torch.cuda.synchronize()
        c = launch_counts()
        if kind != "light_seeking":      # its action search steps the env
            add_launches(counts, c)
        _, outs_p = shaped_episode(env_p, pixel, lambda t, s, o: acts[t])
        equal = all(bool(torch.equal(a, b)) for a, b in zip(outs_k, outs_p))
        equal_all &= equal
        terms = dict.fromkeys(SHAPING_TERMS, 0)
        s, _ = env_k.reset(RL_EPISODES, pixel=pixel)
        for a in acts:
            ns, _, _, _, _ = env_k.step(s, a)
            for k, v in shaping_terms(env_k, s, a, ns).items():
                terms[k] += v
            s = ns
        for k, v in terms.items():
            terms_all[k] += v
        report[kind] = {"kernel_vs_plain_bit_equal": equal,
                        "terms_fired": terms, "launches": c,
                        "mean_total_reward": float(outs_k[-1].mean()),
                        "total_light_hits": int(outs_k[-2].sum())}
    add_launches(launches, counts)
    # Step times on one state, mean of 10 (CUDA events), shaped and base.
    s0, o0 = env_k.reset(RL_EPISODES, pixel=pixel)
    a0 = ppo.predict(o0)
    shaped_ms = cuda_ms(lambda: env_k.step(s0, a0), 10)
    base_ms = cuda_ms(lambda: env_k.env.step(s0.env, a0), 10)
    nh_calls = nearest_hit_calls(lambda: env_k.step(s0, a0))
    nh_err, nh_equal = sweep_vs_plain(nh_calls)
    nh_queued = queued_ms(lambda: [cuda_intersect.nearest_hit(*a, **kw)
                                   for a, kw, _ in nh_calls])
    nh_plain = cuda_ms(lambda: [cuda_intersect.nearest_hit_plain(*a, **kw)
                                for a, kw, _ in nh_calls], 3)
    reachable = [k for k in SHAPING_TERMS if k != "miss_rewrite"]
    emit({"phase": "rl_shaped", **card,
          "env": f"training_scene_complete {RL_W}x{RL_H} fov {RL_FOV}, "
                 f"{RL_BOUNCES} bounces, rl, shaped (light ids 99, 100)",
          "episodes": RL_EPISODES, **report, "terms_fired_total": terms_all,
          "miss_rewrite_note": "unreachable: the base RL step rewards a "
                               "pre-move miss -1.0 (0.0 once done)",
          "shaped_step_ms": shaped_ms, "base_step_ms": base_ms,
          "step_nearest_hit_launches": len(nh_calls),
          "step_nearest_hit_queued_ms": nh_queued,
          "step_nearest_hit_plain_ms": nh_plain,
          "step_sweeps_found_idx_equal": nh_equal,
          "launches": counts, "seconds": time.perf_counter() - t0})
    check(equal_all, "rl_shaped: the kernel route differs from the plain "
          "route")
    check(all(terms_all[k] > 0 for k in reachable)
          and terms_all["miss_rewrite"] == 0,
          f"rl_shaped: terms fired {terms_all}")
    check(nh_equal, "rl_shaped: a step's nearest-hit launch differs from "
          "its plain version")
    check(counts["whitted_trace"] == 2 and counts["nearest_hit"]
          >= 2 * (RL_BOUNCES + 2), f"rl_shaped: launches {counts}")


def transfer_recorder(base, log):
    """``base`` recording its parameters after ``set_parameters`` and after
    ``train``, and each phase's train seconds."""
    class Recorded(base):
        def set_parameters(self, params):
            super().set_parameters(params)
            log.append(("set", self.get_parameters()))

        def train(self, steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = super().train(steps)
            torch.cuda.synchronize()
            # PPO reports iterations; SAC its active env steps.
            taken = out.get("total_steps") or (out["iterations"]
                                               * self.steps_per_iter)
            log.append(("trained", self.get_parameters(),
                        time.perf_counter() - t1, out, taken))
            return out
    return Recorded


def flat_params(params):
    if isinstance(params, torch.Tensor):
        return [params]
    return [t for k in sorted(params) for t in flat_params(params[k])]


def rl_curriculum_phase(dev, card, launches):
    """Phase rl_curriculum: train_with_curriculum over dynamic_scene's
    three phases at 800x600, fov 90, 5 bounces, CUR_STEPS steps a phase,
    with PPO and with SAC (the JAX package's SAC has no parameter transfer;
    the port's moves actor, critics and temperature): each phase's
    parameters after set_parameters equal the last phase's final ones bit
    for bit and training moves them; each phase's steps/s and mean episode
    reward.  As in the JAX flow only phase 1 gets the given config."""
    t0 = time.perf_counter()

    def phase_env(phase):
        scene, gl, pl = dynamic_scene(phase, device=dev)
        return RayTracerEnv(scene, image_width=CUR_W, image_height=CUR_H,
                            fov=CUR_FOV, max_bounces=CUR_BOUNCES,
                            global_lights=gl, point_lights=pl)

    report, failures = {}, []
    reset_counts()
    for algo, cls, cfg in (
            ("ppo", PPOTrainer, PPOConfig()),
            ("sac", SACTrainer, SACConfig(learning_starts=1000))):
        log = []
        _, res = train_with_curriculum(
            phase_env, transfer_recorder(cls, log),
            steps_per_phase=(CUR_STEPS,) * 3, seed=SEED,
            trainer_kwargs={"config": cfg})
        trained = [e for e in log if e[0] == "trained"]
        sets = [e for e in log if e[0] == "set"]
        transfer = all(
            all(bool(torch.equal(a, b)) for a, b in
                zip(flat_params(st[1]), flat_params(tn[1])))
            for st, tn in zip(sets, trained))
        moved = all(
            any(not torch.equal(a, b) for a, b in
                zip(flat_params(st[1]), flat_params(tn[1])))
            for st, tn in zip(sets, trained[1:]))
        phases = []
        for _, _, secs, out, steps in trained:
            phases.append({"seconds": secs, "steps": steps,
                           "steps_per_s": steps / secs,
                           "mean_episode_reward":
                               out["mean_episode_reward"]})
        report[algo] = {"phases": phases, "transfer_bit_equal": transfer,
                        "training_moved_parameters": moved}
        if not (transfer and moved and len(sets) == 2 and len(res) == 3):
            failures.append(algo)
    counts = launch_counts()
    add_launches(launches, counts)
    emit({"phase": "rl_curriculum", **card,
          "env": f"dynamic_scene 1-3 {CUR_W}x{CUR_H} fov {CUR_FOV}, "
                 f"{CUR_BOUNCES} bounces, rl",
          "steps_per_phase": CUR_STEPS, **report, "launches": counts,
          "seconds": time.perf_counter() - t0})
    check(not failures, f"rl_curriculum: transfer failed for {failures}")
    check(counts["whitted_trace"] > 0 and counts["nearest_hit"] > 0,
          f"rl_curriculum: launches {counts}")


INTERACTIVE_RUNS = {
    "1 mode 1": ["1", "1", str(IT_STEPS), "m"],
    "1 mode 2": ["1", "2", str(3 * IT_STEPS), "c"],
    "1 mode 3": ["1", "3", str(IT_STEPS), "m"],
    "2": ["2", str(SHIPPED_DIR / "ppo_raytracer.npz")],
    "3": ["3"],
    "4": ["4"],
    "5": ["5", ""],
    "6": ["6", str(IT_STEPS)],
}


def interactive_phase(dev, card, launches, work_dir):
    """Phase interactive: the CLI's interactive menu on the card with
    scripted answers (options 1 in its three modes, 2 on the shipped PPO,
    3, 4, 5, 6) at tiny step counts, in ``work_dir``; then option 4's
    integration example run as printed."""
    t0 = time.perf_counter()
    report = {}
    reset_counts()
    with in_dir(work_dir):
        for name, answers in INTERACTIVE_RUNS.items():
            it = iter(answers)

            def input_fn(prompt, it=it):
                try:
                    return next(it)
                except StopIteration:
                    raise EOFError from None

            buf = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.cmd_interactive(types.SimpleNamespace(
                    seed=SEED, device="cuda"), input_fn=input_fn)
            torch.cuda.synchronize()
            out = buf.getvalue()
            report[name] = {"seconds": time.perf_counter() - t1,
                            "lines": len(out.splitlines())}
            if name.startswith("1") or name == "2":
                report[name]["evaluation"] = json.loads(
                    out.strip().splitlines()[-1])
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            ns = {}
            exec(compile(cli.INTEGRATION_EXAMPLE, "integration_example",
                         "exec"), ns)
        torch.cuda.synchronize()
        report["4"]["example_seconds"] = time.perf_counter() - t1
        files = sorted(p.name for p in work_dir.iterdir())
    counts = launch_counts()
    add_launches(launches, counts)
    emit({"phase": "interactive", **card, "runs": report, "files": files,
          "launches": counts, "seconds": time.perf_counter() - t0})
    for f in ("m.pkl", "c.pkl", "raytracer_final.pkl",
              "raytracer_final_benchmark.json",
              "rl_vs_traditional_comparison.png"):
        check(f in files, f"interactive: no {f}")
    check(all(r["evaluation"]["episodes"] == 20 for k, r in report.items()
              if "evaluation" in r), "interactive: an evaluation")
    check(ns["img"].shape == (600, 800, 3) and ns["stats"].total_rays > 0,
          "interactive: the integration example's render")
    check(counts["whitted_trace"] > 0 and counts["nearest_hit"] > 0
          and sum(counts["path_trace"].values()) > 0,
          f"interactive: launches {counts}")


def quiet(fn, log_path):
    """``fn()`` with its standard output and errors in ``log_path``; its
    wall seconds (the card synchronized) and its result."""
    t1 = time.perf_counter()
    with open(log_path, "w") as f, contextlib.redirect_stdout(f), \
            contextlib.redirect_stderr(f):
        out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t1, out


def ship_tools_phase(dev, card, launches):
    """Phase ship_tools: the recipes on the card, into build/ship/:
    ship_models train-chandelier (ST_SCENES scenes of ST_STEPS walkers in
    the three chunks, guide_prob 0 -> 0.25 -> 0.5; the nearest-hit kernel a
    walk step), distill --sharpen of its teacher, eval of that student
    (stepwise: the nearest-hit kernel a level), heldout-chandelier (the
    one-step probes, and the render comparison through the path kernels),
    and ship_rl ppo-sweep at --scale ST_SWEEP_SCALE (the Whitted and
    nearest-hit kernels through the env); the wall time of each."""
    t0 = time.perf_counter()
    out = ROOT / "build" / "ship"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    teacher = out / "fb_chandelier_trained.npz"
    student = out / "fb_chandelier_distilled_card.npz"
    here = os.getcwd()
    os.chdir(ROOT)                   # the tools write under build/ship/
    reset_counts()
    try:
        walls = {}
        walls["train_chandelier"], _ = quiet(lambda: ship_models.main([
            "train-chandelier", "--scenes", str(ST_SCENES), "--steps",
            str(ST_STEPS), "--out", str(teacher)]), out / "train.log")
        walls["distill_sharpen"], _ = quiet(lambda: ship_models.main([
            "distill", "--scene", "chandelier", "--teacher", str(teacher),
            "--out", str(student), "--sharpen", "--frames", str(ST_FRAMES),
            "--epochs", str(ST_EPOCHS)]), out / "distill.log")
        walls["eval"], stats = quiet(lambda: ship_models.main([
            "eval", "--scene", "chandelier", "--model", str(student)]),
            out / "eval.log")
        walls["heldout_chandelier"], held = quiet(lambda: ship_models.main([
            "heldout-chandelier", "--teacher", str(teacher), "--student",
            str(student)]), out / "heldout.log")
        walls["ppo_sweep"], sweep = quiet(lambda: ship_rl.main([
            "ppo-sweep", "--scale", str(ST_SWEEP_SCALE)]),
            out / "ppo_sweep.log")
    finally:
        os.chdir(here)
    counts = launch_counts()
    add_launches(launches, counts)
    emit({"phase": "ship_tools", **card, "wall_seconds": walls,
          "train_chandelier": f"{ST_SCENES} scenes x {ST_STEPS} steps",
          "distill": f"--sharpen --frames {ST_FRAMES} --epochs {ST_EPOCHS}",
          "eval_comparison": stats["comparison"],
          "heldout": {k: held[k] for k in ("teacher_one_step",
                                           "student_one_step",
                                           "render_level")},
          "ppo_sweep": {"scale": ST_SWEEP_SCALE, "best": sweep["best"],
                        "random_hit_rate":
                            sweep["random"]["light_hit_rate"],
                        "candidates": {k: {
                            "hit_z_vs_random": v["hit_z_vs_random"],
                            "light_hit_rate": v["eval"]["light_hit_rate"],
                            "timesteps": v["timesteps"]}
                            for k, v in sweep["sweep"].items()}},
          "launches": counts, "seconds": time.perf_counter() - t0})
    check(teacher.exists() and student.exists()
          and (out / "ppo_best.npz").exists(), "ship_tools: outputs")
    check(stats["traditional"]["total_rays"] > 0
          and stats["fb"]["total_rays"] > 0, f"ship_tools: eval {stats}")
    check(counts["nearest_hit"] > 0 and counts["whitted_trace"] > 0
          and counts["path_trace"]["unguided"] > 0
          and counts["path_trace"]["bf16_mma"] > 0,
          f"ship_tools: launches {counts}")


def figures_phase(dev, card, launches):
    """Phase figures: whether matplotlib is present, and the three flows
    that draw a figure as a side product (train-ppo --analyze,
    run_custom_scene_experiment, render_comparison) run to their end on
    the card, with the figure or the line saying it was not drawn."""
    from raytracer_tpu_torch.utils.figures import have_matplotlib
    t0 = time.perf_counter()
    has_mpl = have_matplotlib()
    reset_counts()
    flows = {}
    with in_dir(ROOT / "build" / "figures") as d:
        for name, fn, png in (
                ("train_ppo_analyze", lambda: cli.main([
                    "train-ppo", "--timesteps", "1792", "--out", "p.npz",
                    "--analyze"]), d / "ppo_analysis.png"),
                ("custom_scene_experiment", lambda: CustomSceneExperiment(
                    output_dir=str(d), mode=O5_MODE,
                    device=dev).run_custom_scene_experiment(), None),
                ("render_comparison", lambda: rl_renderer.RayTracerRL(
                    str(SHIPPED_DIR / "sac_raytracer.npz"),
                    device=dev).render_comparison(
                        200, 150, str(d / "rl_vs_traditional.png")),
                 d / "rl_vs_traditional.png")):
            buf = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                fn()
            torch.cuda.synchronize()
            if png is None:
                png = next(d.glob("experiment_*")) / \
                    "custom_scene_analysis.png"
            noted = "not drawn: matplotlib is not installed" in \
                buf.getvalue()
            flows[name] = {"seconds": time.perf_counter() - t1,
                           "figure_written": png.exists(),
                           "not_drawn_line": noted}
    counts = launch_counts()
    add_launches(launches, counts)
    emit({"phase": "figures", **card, "matplotlib": has_mpl,
          "flows": flows, "launches": counts,
          "seconds": time.perf_counter() - t0})
    for name, f in flows.items():
        check((f["figure_written"] and not f["not_drawn_line"]) if has_mpl
              else f["not_drawn_line"], f"figures: {name} {f}")
    check(flows["render_comparison"]["figure_written"],
          "figures: render_comparison wrote no PNG")


def train_recipes_phase(dev, card, launches):
    """Phase train_recipes: the training recipes the card had not run, into
    build/ship/ (after ship_tools, whose chandelier teacher it reads):
    ship_models train-multi at the reference protocol and eval-multi of
    its teacher (uncut; the ratio beside JAX's recorded 1.70x), then, cut
    to size (TR_*), train-complex, distill-ensemble of the card's
    chandelier and multi-scene teachers on the chandelier with the
    student's heldout-chandelier (its render through the path kernels)
    and eval-multi, distill-episodes --type cornell_box from the
    multi-scene teacher with the student's eval (the path kernels) and
    eval-multi, and ship_rl ppo-ship and sac-ship (the Whitted and
    nearest-hit kernels through the env).  Each recipe's wall seconds and
    launches by kernel; each must write its outputs and launch every
    kernel on its route."""
    t0 = time.perf_counter()
    out = ROOT / "build" / "ship"
    out.mkdir(parents=True, exist_ok=True)
    chand = out / "fb_chandelier_trained.npz"
    multi = out / "fb_multi_scene_trained.npz"
    held = out / "fb_multi_scene_held_out.json"
    complex_t = out / "fb_complex_trained.npz"
    ens = out / "fb_chandelier_ensemble_card.npz"
    epi = out / "fb_cornell_episodes_card.npz"
    recipes = {}
    here = os.getcwd()
    os.chdir(ROOT)                   # the tools write under build/ship/

    def run(name, fn, need):
        reset_counts()
        wall, res = quiet(fn, out / f"{name}.log")
        c = launch_counts()
        add_launches(launches, c)
        recipes[name] = {"wall_seconds": wall, "launches": c}
        flat = {"unguided": c["path_trace"]["unguided"],
                "bf16_mma": c["path_trace"]["bf16_mma"], **{
                    k: v for k, v in c.items() if k != "path_trace"}}
        check(all(flat[k] > 0 for k in need),
              f"train_recipes: {name} launched {c}, needs {need}")
        return res

    def models(*argv):
        return lambda: ship_models.main(list(map(str, argv)))

    try:
        run("train_multi", models(
            "train-multi", "--scenes", TR_MULTI[0], "--steps", TR_MULTI[1],
            "--out", multi, "--workdir", out / "multi_work"),
            ["nearest_hit"])
        run("eval_multi", models(
            "eval-multi", "--model", multi, "--scenes", TR_EVAL[0],
            "--episodes", TR_EVAL[1], "--seed", 0, "--out", held),
            ["nearest_hit"])
        run("train_complex", models(
            "train-complex", "--scenes", TR_COMPLEX[0], "--steps",
            TR_COMPLEX[1], "--out", complex_t, "--workdir",
            out / "complex_work"), ["nearest_hit"])
        run("distill_ensemble", models(
            "distill-ensemble", "--scene", "chandelier", "--teachers", chand,
            multi, "--out", ens, "--frames", TR_DISTILL[0], "--epochs",
            TR_DISTILL[1]), ["nearest_hit"])
        ens_held = run("heldout_ensemble", models(
            "heldout-chandelier", "--teacher", chand, "--student", ens,
            "--out", out / "heldout_ensemble.json"),
            ["nearest_hit", "unguided", "bf16_mma"])
        run("eval_multi_ensemble", models(
            "eval-multi", "--model", ens, "--type", "chandelier_scene",
            "--scenes", TR_STUDENT_SCENES, "--out",
            out / "held_out_ensemble_multi.json"), ["nearest_hit"])
        run("distill_episodes", models(
            "distill-episodes", "--type", "cornell_box", "--teacher", multi,
            "--out", epi, "--scenes", TR_EPISODES[0], "--walkers",
            TR_EPISODES[1], "--epochs", TR_EPISODES[2]), ["nearest_hit"])
        epi_stats = run("eval_episodes_student", models(
            "eval", "--scene", "cornell_box", "--model", epi, "--out",
            out / "eval_cornell"), ["unguided", "bf16_mma"])
        run("eval_multi_episodes_student", models(
            "eval-multi", "--model", epi, "--type", "cornell_box",
            "--scenes", TR_STUDENT_SCENES, "--out",
            out / "held_out_cornell_multi.json"), ["nearest_hit"])
        ppo = run("ppo_ship", lambda: ship_rl.cmd_ppo_ship(
            ship_rl.build_parser().parse_args(["ppo-ship"]),
            stages=[(e, int(n * TR_PPO_SCALE))
                    for e, n in ship_rl.SHIP_STAGES],
            eval_episodes=TR_RL_EVAL, cpu_probe_steps=TR_RL_CPU_PROBE),
            ["whitted_trace", "nearest_hit"])
        sac = run("sac_ship", lambda: ship_rl.main([
            "sac-ship", "--timesteps", str(TR_SAC_STEPS), "--eval-episodes",
            str(TR_RL_EVAL), "--cpu-probe-steps", str(TR_RL_CPU_PROBE)]),
            ["whitted_trace", "nearest_hit"])
    finally:
        os.chdir(here)
    train = json.loads((out / "multi_work" /
                        "final_training_report.json").read_text())
    ho = json.loads(held.read_text())
    cx = json.loads((out / "complex_work" /
                     "held_out_complex_test.json").read_text())
    students = {name: {k: r[k] for k in ("policy_hit_rate",
                                         "random_hit_rate", "ratio")}
                for name, r in (
                    ("ensemble_chandelier", json.loads(
                        (out / "held_out_ensemble_multi.json").read_text())),
                    ("episodes_cornell", json.loads(
                        (out / "held_out_cornell_multi.json").read_text())))}
    emit({"phase": "train_recipes", **card,
          "train_multi": {
              "protocol": f"{TR_MULTI[0]} scenes x {TR_MULTI[1]} walkers, "
                          "FBConfig(), chunks guide_prob 0/0.25/0.5",
              "avg_hit_rate":
                  train["performance_statistics"]["avg_hit_rate"],
              "scenes": len(train["all_performances"]),
              "buffer": train["training_summary"]["final_buffer_size"],
              "transitions": train["training_summary"]["agent_stats"][
                  "performance"]["total_rays"]},
          "eval_multi": {k: ho[k] for k in ("num_scenes",
                                            "episodes_per_scene", "seed",
                                            "policy_hit_rate",
                                            "random_hit_rate", "ratio")},
          "eval_multi_jax_recorded": JAX_MULTI_HELD_OUT,
          "train_complex": {"cut": f"{TR_COMPLEX[0]} scenes x "
                                   f"{TR_COMPLEX[1]} walkers", **cx},
          "ensemble_render": ens_held["render_level"],
          "episodes_student_render": epi_stats["comparison"],
          "students_eval_multi": students,
          "ppo_ship": {"stages": [r["timesteps"] for r in
                                  ppo["config"]["stages"]],
                       "hit_rate": ppo["card"]["eval"]["light_hit_rate"],
                       "z_vs_random": ppo["card"]["light_hit_z_vs_random"],
                       "steps_per_sec": ppo["card"]["steps_per_sec"]},
          "sac_ship": {"active_steps": sac["card"]["total_steps"],
                       "hit_rate": sac["card"]["eval"]["light_hit_rate"],
                       "z_vs_random": sac["card"]["light_hit_z_vs_random"]},
          "recipes": recipes, "seconds": time.perf_counter() - t0})
    for f in (multi, held, complex_t, ens, epi, out / "ppo_raytracer.npz",
              out / "sac_raytracer_card.npz"):
        check(f.exists(), f"train_recipes: {f.name} not written")
    check(len(train["all_performances"]) == TR_MULTI[0]
          and recipes["train_multi"]["launches"]["nearest_hit"]
          == TR_MULTI[0] * FBConfig().max_bounces,
          f"train_recipes: train-multi {recipes['train_multi']}")
    check(recipes["eval_multi"]["launches"]["nearest_hit"]
          == 2 * TR_EVAL[0] * FBConfig().max_bounces
          and 0 < ho["random_hit_rate"] < 1
          and 0 <= ho["policy_hit_rate"] <= 1,
          f"train_recipes: eval-multi {ho}")
    check(epi_stats["traditional"]["total_rays"] > 0
          and epi_stats["fb"]["total_rays"] > 0,
          f"train_recipes: the episode student's eval {epi_stats}")


def teacher_renders_phase(dev, card, launches):
    """Phase teacher_renders: the route on which a card-trained teacher's
    light hits are read (PERF.md §6): ship_models eval of each
    teacher this run trained (ship_tools' chandelier teacher, cut;
    train_recipes' multi-scene and complex teachers) as a full guide on
    the chandelier at 200x100@8spp/8, seed 5, the harness's stepwise side
    (the nearest-hit kernel a level, the guide between levels), against
    the traditional frame on the same route.  Small-light hits and the
    guided bounces' successes; the traditional frame must make
    TEACHER_TRADITIONAL_HITS, the count every recorded render of this
    route gave.  No bound on a teacher's own hits: they vary from 0 to
    ~2,000 with the seed in both packages (PERF.md §6), and these
    teachers are cut or trained on other scenes."""
    t0 = time.perf_counter()
    out = ROOT / "build" / "ship"
    renders = {}
    here = os.getcwd()
    os.chdir(ROOT)
    try:
        for name in ("fb_chandelier_trained", "fb_multi_scene_trained",
                     "fb_complex_trained"):
            reset_counts()
            wall, st = quiet(lambda: ship_models.main([
                "eval", "--scene", "chandelier", "--model",
                str(out / f"{name}.npz"), "--size",
                f"{TEACHER_FRAME[0]}x{TEACHER_FRAME[1]}", "--spp",
                str(TEACHER_FRAME[2]), "--seed", str(TEACHER_SEED),
                "--out", str(out / f"eval_{name}")]),
                out / f"eval_{name}.log")
            c = launch_counts()
            add_launches(launches, c)
            renders[name] = {
                "wall_seconds": wall, "launches": c,
                "implementations": st["implementations"],
                "traditional_small_light_hits":
                    st["traditional"]["small_light_hits"],
                "fb_small_light_hits": st["fb"]["small_light_hits"],
                "fb_success_rate": st["fb"].get("fb_success_rate"),
                "small_light_improvement":
                    st["comparison"]["small_light_improvement"]}
    finally:
        os.chdir(here)
    emit({"phase": "teacher_renders", **card,
          "frame": "chandelier {}x{}@{}spp/8 seed {}".format(
              *TEACHER_FRAME, TEACHER_SEED),
          "renders": renders, "seconds": time.perf_counter() - t0})
    for name, r in renders.items():
        impl = r["implementations"]
        check(impl["traditional"] == impl["fb"] == "stepwise"
              and r["launches"]["nearest_hit"] > 0,
              f"teacher_renders: {name} route {r}")
        check(r["traditional_small_light_hits"] == TEACHER_TRADITIONAL_HITS,
              f"teacher_renders: {name} traditional frame {r}")

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. Device -------------------------------------------------------------
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    card = {"device": kind, "nvidia_smi": smi_line}
    emit({"phase": "device", "kind": kind, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    # 2. Build ----------------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc a source
        libs = dict(zip(SOURCES, pool.map(native.load, SOURCES)))
    lib = libs["path_trace"]
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": str(lib.path.relative_to(ROOT)),
          "nvcc_seconds": lib.build_seconds, "ptxas": ptxas,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "whitted_build", "libraries": {
        n: {"library": str(libs[n].path.relative_to(ROOT)),
            "nvcc_seconds": libs[n].build_seconds,
            "ptxas": [ln.strip() for ln in libs[n].build_log.splitlines()
                      if "registers" in ln or "spill" in ln]}
        for n in ("whitted_trace", "nearest_hit")}})

    # 3. Main path: render_path through the kernel, then the plain version
    #    on the same draws (same seed).
    t0 = time.perf_counter()
    scene, _, _, params = chandelier_scene(device=dev)
    kw = dict(width=W, height=H, spp=SPP, max_bounces=BOUNCES,
              fov=params["fov"], camera_position=params["camera_position"],
              mirror_threshold=0.0, background=BG, device=dev)
    reset_counts()
    img_k, st_k = render_path(scene, impl="kernel",
                              generator=torch.Generator(dev).manual_seed(SEED),
                              **kw)
    torch.cuda.synchronize()
    launches = cuda_path.path_trace.launches
    check(launches >= 1, "the main path launched no path_trace kernel")
    img_p, st_p = render_path(scene, impl="plain",
                              generator=torch.Generator(dev).manual_seed(SEED),
                              **kw)
    torch.cuda.synchronize()
    check(tuple(img_k.shape) == (H, W, 3), f"image shape {img_k.shape}")
    check(bool(torch.isfinite(img_k).all()), "non-finite pixels")
    check(float(img_k.min()) >= 0.0 and float(img_k.max()) <= 1.0,
          "pixels outside [0, 1]")
    sk, sp = st_k.as_dict(), st_p.as_dict()
    check(sk["total_rays"] >= W * H * SPP and sk["light_hits"] > 0,
          f"implausible stats {sk}")
    equal = bool(torch.equal(img_k, img_p)) and sk == sp
    off = (img_k - img_p).abs().amax(-1) > 1 / 255 + 1e-7
    off_frac = float(off.float().mean())
    # Fallback bound, the TPU kernel's own (core/pallas_path.py:36-45):
    # <= 0.1% of pixels off by more than 1/255, hit counts within 0.02%.
    check(equal or (off_frac <= 1e-3 and stats_close(sk, sp, 2e-4)),
          f"kernel frame differs from plain: {off_frac} of pixels off, "
          f"stats {sk} vs {sp}")
    emit({"phase": "main_path", "frame": f"{W}x{H}@{SPP}spp/{BOUNCES}",
          "launches": launches, "bit_equal": equal,
          "pixels_off_fraction": off_frac, "stats_kernel": sk,
          "stats_plain": sp, "seconds": time.perf_counter() - t0})

    # Kernel vs plain at the main path's shapes, wrapper to wrapper.
    jitter = torch.rand((SPP, H, W, 2), device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
    o, d = perspective_rays(W, H, fov=params["fov"],
                            origin=params["camera_position"],
                            sample_xy=jitter)
    o = o.contiguous()
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 0.0, dev)
    tkw = dict(max_bounces=BOUNCES, background=BG)
    rgb_k, cnt_k = cuda_path.path_trace(o, d, None, table, **tkw)
    # The plain trace, its work counted level by level for the bound.
    rgb_p, cnt_p, work = traced_work(o, d, None, table, **tkw)
    torch.cuda.synchronize()
    max_abs_err = float((rgb_k - rgb_p).abs().max())
    samples_off = float((rgb_k != rgb_p).any(-1).float().mean())
    sums_k = dict(zip("rfes", cnt_k.sum(0, dtype=torch.int64).tolist()))
    sums_p = dict(zip("rfes", cnt_p.sum(0, dtype=torch.int64).tolist()))
    # Expected bit-equal; the fallback bound is the TPU kernel's (above).
    check((max_abs_err == 0 and sums_k == sums_p)
          or (samples_off <= 1e-3 and stats_close(sums_k, sums_p, 2e-4)),
          f"kernel vs plain: max |err| {max_abs_err}, {samples_off} of "
          f"samples differ, counts {sums_k} vs {sums_p}")
    emit({"phase": "kernel_vs_plain", "rays": o.shape[0],
          "max_abs_err": max_abs_err, "samples_off_fraction": samples_off,
          "counts_kernel": sums_k, "counts_plain": sums_p})

    # The square roots and divides of the frame's levels, counted on its
    # data (tools/level_edges.py::level_work): as the plain version and
    # the parent kernel take them, and as the kernel takes them now.
    per_level = {k: v / work["ray_levels"] for k, v in work.items()
                 if k.startswith(("before", "after"))}

    # 4. Golden on the card: pixel centres, spp 1, 8 bounces.
    t0 = time.perf_counter()
    og, dg = perspective_rays(W, H, fov=params["fov"],
                              origin=params["camera_position"], device=dev)
    rgb_g, _ = trace_path(scene, og, dg, max_bounces=BOUNCES,
                          mirror_threshold=0.0, background=BG, impl="kernel")
    img = rgb_g.cpu().numpy().reshape(H, W, 3).astype(np.float64)
    ref = np.load(GOLDEN).astype(np.float64)
    dd = np.abs(np.minimum(1.0, img / 255.0) - np.minimum(1.0, ref / 255.0))
    agree = dd.max(axis=-1) <= 1 / 255
    divergent = int((~agree).sum())
    mse_agree = float(np.mean(dd[agree] ** 2))
    emit({"phase": "golden", "divergent_pixels": divergent,
          "mse_agreeing": mse_agree,
          "exact_pixel_fraction": float((dd.max(-1) == 0).mean()),
          "bounds": {"divergent_pixels": "< 1000", "mse_agreeing": "< 1e-8"},
          "seconds": time.perf_counter() - t0})
    check(divergent < 1000 and mse_agree < 1e-8,
          f"golden: {divergent} divergent pixels, mse {mse_agree}")

    # 5. Diffuse bounces (mirror_threshold=0.9) and a ragged ray count.
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    jd = torch.rand((2, 150, 200, 2), device=dev, generator=gen)
    od, ddir = perspective_rays(200, 150, fov=params["fov"],
                                origin=params["camera_position"],
                                sample_xy=jd)
    u = torch.rand((BOUNCES, od.shape[0], 2), device=dev, generator=gen)
    dkw = dict(max_bounces=BOUNCES, mirror_threshold=0.9, background=BG,
               uniforms=u)
    rk, sdk = trace_path(scene, od, ddir, impl="kernel", **dkw)
    rp, sdp = trace_path(scene, od, ddir, impl="plain", **dkw)
    eq_frac = float((rk == rp).float().mean())
    sdk, sdp = sdk.as_dict(), sdp.as_dict()
    hits = ("total_rays", "total_intersections", "light_hits")
    diffuse_ok = eq_frac >= 0.95 and stats_close(
        {k: sdk[k] for k in hits}, {k: sdp[k] for k in hits}, 0.02)
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    orr = torch.zeros((3601, 3), device=dev) + torch.tensor(
        params["camera_position"], dtype=torch.float32, device=dev)
    drr = torch.randn((3601, 3), device=dev, generator=gen)
    r1, s1 = trace_path(scene, orr, drr, max_bounces=BOUNCES,
                        mirror_threshold=0.0, impl="kernel")
    r2, s2 = trace_path(scene, orr, drr, max_bounces=BOUNCES,
                        mirror_threshold=0.0, impl="plain")
    ragged_equal = bool(torch.equal(r1, r2)) and s1.as_dict() == s2.as_dict()
    emit({"phase": "diffuse_and_ragged", "diffuse_subpixels_equal": eq_frac,
          "diffuse_stats_kernel": sdk, "diffuse_stats_plain": sdp,
          "ragged_3601_bit_equal": ragged_equal,
          "seconds": time.perf_counter() - t0})
    check(diffuse_ok, f"diffuse kernel vs plain: {eq_frac} equal, "
          f"stats {sdk} vs {sdp}")
    check(ragged_equal, "ragged 3601-ray kernel vs plain differ")

    level_edges_phase(dev)

    # 6. Times on the card's clock at the main path's shapes.
    t0 = time.perf_counter()
    for _ in range(3):
        cuda_path.path_trace(o, d, None, table, **tkw)
    kernel_ms = cuda_ms(lambda: cuda_path.path_trace(o, d, None, table,
                                                     **tkw), 20)
    plain_ms = cuda_ms(lambda: cuda_path.path_trace_plain(o, d, None, table,
                                                          **tkw), 3)
    walls = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(5):
        t1 = time.perf_counter()
        render_path(scene, impl="kernel",
                    generator=torch.Generator(dev).manual_seed(SEED), **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    n_rays = o.shape[0]
    ops, ops_plain = level_ops(work)
    ops += OPS_PER_RAY * n_rays
    nbytes = BYTES_PER_RAY * n_rays
    bms, bby = bound(ops, nbytes)
    emit({"phase": "times", **card, "frame": f"{W}x{H}@{SPP}spp/{BOUNCES}",
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "render_path_wall_ms": walls, "render_path_wall_ms_min": min(walls),
          "total_rays": sk["total_rays"], "camera_rays": n_rays,
          "rays_per_s_kernel": sk["total_rays"] / (kernel_ms / 1e3),
          "rays_per_s_wall": sk["total_rays"] / (min(walls) / 1e3),
          "bound_ms": bms, "bound_by": bby, "bound_ops": ops,
          "bound_bytes": nbytes, "bound_share": bms / kernel_ms,
          "plain_ops": ops_plain + OPS_PER_RAY * n_rays,
          "level_work": work, "sqrt_div_per_ray_level": per_level,
          "max_memory_allocated_bytes": peak,
          "library_ms": None,
          "library_note": "no single PyTorch call computes this function",
          "seconds": time.perf_counter() - t0})

    shade_kernel, whitted_kernels = whitted_phases(dev, card)
    guided_kernels = guided_phases(dev, card, scene, params, libs)
    norm_launches = fb_agent_phases(dev, card, scene, params)
    norm_kernel = guide_norm_phase(dev, card, scene, params, norm_launches)
    train_dir = ROOT / "build" / "fb_train"
    shutil.rmtree(train_dir, ignore_errors=True)
    trainer, ckpt, walk_kernel = fb_train_phase(dev, card, train_dir)
    fb_guide_dtypes_phase(dev, card, scene, params, trainer.config, ckpt)

    # The harness, the distillation and the output5 experiment: new routes
    # through the kernels above, their launches summed by kernel.
    out_dir = ROOT / "build" / "harness"
    shutil.rmtree(out_dir, ignore_errors=True)
    new_routes = {}
    compare_student_phase(dev, card, scene, params, out_dir, new_routes)
    compare_complex_phase(dev, card, out_dir, new_routes)
    compare_agent_phase(dev, card, scene, params, ckpt, out_dir, new_routes)
    compare_chunked_phase(dev, card, scene, params, out_dir, new_routes)
    distill_kernel = distill_phase(dev, card, scene, params, ckpt, out_dir,
                                   new_routes)
    output5_kernel = output5_phase(dev, card, out_dir, new_routes)
    # The RL track: its routes through the Whitted and nearest-hit kernels.
    t_rl = time.perf_counter()
    rl_routes = {}
    rl_env_kernels = rl_env_phase(dev, card, rl_routes)
    rl_eval_phase(dev, card, rl_routes)
    rl_train_phase(dev, card, rl_routes)
    rl_render_kernel = rl_render_phase(dev, card, rl_routes)
    emit({"phase": "rl_total", "launches": rl_routes,
          "seconds": time.perf_counter() - t_rl})
    # The frame-serving extras: turntables, compact Whitted, sharded
    # renders, the .pth import and the CLI's animate.
    t_fx = time.perf_counter()
    fx_routes = {}
    animate_kernels = animate_whitted_phase(dev, card, fx_routes)
    animate_path_phase(dev, card, fx_routes)
    compact_kernel = whitted_compact_phase(dev, card, fx_routes,
                                           ROOT / "build" / "compact_trace")
    sharded_phase(dev, card, fx_routes)
    pth_import_phase(dev, card, scene, params, ROOT / "build" / "pth_import")
    cli_animate_phase(dev, card, ROOT / "build" / "animate")
    fx_total = {}
    for counts in fx_routes.values():
        add_launches(fx_total, counts)
    emit({"phase": "frame_extras_total", "launches": fx_routes,
          "seconds": time.perf_counter() - t_fx})
    # The rest of the RL track (the shaped env, the curriculum), the CLI's
    # interactive menu, the recipes and the figures.
    t_cr = time.perf_counter()
    cr_total = {}
    rl_shaped_phase(dev, card, cr_total)
    rl_curriculum_phase(dev, card, cr_total)
    interactive_phase(dev, card, cr_total, ROOT / "build" / "interactive")
    ship_tools_phase(dev, card, cr_total)
    figures_phase(dev, card, cr_total)
    emit({"phase": "curriculum_recipes_total", "launches": cr_total,
          "seconds": time.perf_counter() - t_cr})
    # The training recipes: train-multi and eval-multi uncut, the other
    # recipes cut to size.
    t_tr = time.perf_counter()
    tr_total = {}
    train_recipes_phase(dev, card, tr_total)
    teacher_renders_phase(dev, card, tr_total)
    emit({"phase": "training_recipes_total", "launches": tr_total,
          "seconds": time.perf_counter() - t_tr})
    by_entry = {"path_trace": new_routes["path_trace"]["unguided"],
                "path_trace_guided": new_routes["path_trace"]["bf16_mma"],
                "path_level": new_routes["path_level"],
                "whitted_trace": new_routes["whitted_trace"],
                "nearest_hit": new_routes["nearest_hit"]}

    kernels = [{
        "name": "path_trace", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/path_trace.cu",
        "replaces": "raytracer_tpu/core/pallas_path.py:213",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
        "library_ms": None}] + whitted_kernels + guided_kernels
    fx_entry = {"path_trace": fx_total["path_trace"]["unguided"],
                "path_trace_guided": fx_total["path_trace"]["bf16_mma"],
                "path_level": fx_total["path_level"],
                "whitted_trace": fx_total["whitted_trace"],
                "nearest_hit": fx_total["nearest_hit"]}
    cr_entry = {"path_trace": cr_total["path_trace"]["unguided"],
                "path_trace_guided": cr_total["path_trace"]["bf16_mma"],
                "path_level": cr_total["path_level"],
                "whitted_trace": cr_total["whitted_trace"],
                "nearest_hit": cr_total["nearest_hit"]}
    tr_entry = {"path_trace": tr_total["path_trace"]["unguided"],
                "path_trace_guided": tr_total["path_trace"]["bf16_mma"],
                "path_level": tr_total["path_level"],
                "whitted_trace": tr_total["whitted_trace"],
                "nearest_hit": tr_total["nearest_hit"]}
    for k in kernels:
        k["launches_harness_distill_output5"] = by_entry[k["name"]]
        k["launches_frame_extras"] = fx_entry[k["name"]]
        k["launches_curriculum_recipes"] = cr_entry[k["name"]]
        k["launches_training_recipes"] = tr_entry[k["name"]]
        if k["name"] in ("whitted_trace", "nearest_hit"):
            k["launches_rl"] = rl_routes[k["name"]]
    emit({"kernels": kernels + [walk_kernel, distill_kernel,
                                output5_kernel] + rl_env_kernels
          + [rl_render_kernel] + animate_kernels + [compact_kernel]
          + [norm_kernel, shade_kernel]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
