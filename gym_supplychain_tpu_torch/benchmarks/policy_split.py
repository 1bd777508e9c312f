"""Where the policy lane kernel's time goes: the MLP against the env step.

Builds two variants of ``csrc/supplychain_policy.cu`` beside the package's
library (into ``_build/variants/``) and times, on ``supplychain-ntom-v0``
at hidden (128, 128) and ``--envs`` environments:

* K4 (``launch_supplychain_greedy``): one greedy episode, T = 360;
* K1 ``policy`` (``launch_supplychain_policy``): the trainer's shape, one
  episode of T = 60, sample-major;

each whole, with the MLP cut out (``no_mlp``: the action is tanh(0), the
value 0) and with the env step cut out (``no_step``: the reward is the
first action, the state stays as reset).  ``mlp_ms`` is whole less
``no_mlp``, ``step_ms`` whole less ``no_step``, ``rest_ms`` what both
leave (demand row, observation, obs stream, syncs, action).  The builds
run in turns (whole, no_mlp, no_step, twice), each time the median of
``--reps`` calls after a warm-up between CUDA events.  Needs a CUDA device
and nvcc; prints one JSON object with the card's name and power limit.
``--whole`` times the built library alone (no variants): each kernel's
launch between CUDA events.

    python -m gym_supplychain_tpu_torch.benchmarks.policy_split [--reps 7]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from .. import make_chain
from ..models.policy import ActorCritic, MLPConfig
from ..ops import _build
from ..ops import supplychain_collect as scc
from ..ops import supplychain_dense as scd
from ..ops import supplychain_episode as sce
from ..ops._mlp import MlpLayout
from ..rng.device import device_episode_tables
from .large_topologies import _timed

HIDDEN = (128, 128)
# (old, new) text of csrc/supplychain_policy.cu, every occurrence
VARIANTS = {
    "no_mlp": (("    pl_net(lay, W, 0,", "    if (0) pl_net(lay, W, 0,"),
               ("if (!greedy) pl_net(", "if (0) pl_net("),
               ("tanhf(mu_s[i * E + e])", "tanhf(0.0f)"),
               ("const float mu = mu_s[i * E + e];", "const float mu = 0.0f;"),
               ("= v_s[e];", "= 0.0f;")),
    "no_step": (("r = ln_step<G, DT>(ch, ed, env, in, te + 1, g);",
                 "r = act[0];"),),
}


def variant_sources() -> dict:
    """Each variant's source text; raises where the kernel source no longer
    holds a text a variant replaces."""
    src = (_build.CSRC / "supplychain_policy.cu").read_text()
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in "
                                   "csrc/supplychain_policy.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build_variants() -> dict:
    """Each variant as a library with the policy kernel's entry (and the
    error strings and descriptor sizes its wrappers read), built in
    parallel."""
    out_dir = _build.BUILD_ROOT / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), "-o", str(out_dir / f"{name}.so"), str(cu),
             str(_build.CSRC / "supplychain_collect.cu"),
             str(_build.CSRC / "supplychain_dense.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, p in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}{err}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn in ("sc_policy_lane_launch", "dn_chain_bytes",
                   "dn_edges_bytes", "mlp_layout_ints"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        lib.gst_error_string.argtypes = [ctypes.c_int]
        lib.gst_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def run_benchmark(B: int = 4096, reps: int = 7, seed: int = 0,
                  whole: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the policy split times the CUDA kernels: no CUDA "
                           "device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    libs = {"whole": _build.library(), **({} if whole else
                                          _build_variants())}
    cc = make_chain("supplychain-ntom-v0")
    cc60 = make_chain("supplychain-ntom-v0", total_time_steps=60)
    model = ActorCritic(MLPConfig(cc.obs_dim, cc.A, HIDDEN),
                        torch.Generator().manual_seed(seed), device=dev)
    with torch.no_grad():
        model.mu.w.mul_(100.0)                  # non-degenerate actions
    lay = MlpLayout(cc.obs_dim, cc.A, HIDDEN)
    net = (lay, torch.as_tensor(lay.ints, device=dev),
           lay.pack(model.flat()))
    dem, lt = device_episode_tables((seed, 0), cc, B, device=dev)
    k4 = (torch.as_tensor(scd.dense_descriptor(cc), device=dev), cc, *net, B,
          dem, lt)
    k1 = (torch.as_tensor(scd.dense_descriptor(cc60), device=dev), cc60,
          *net, 60, B, "policy")
    calls = {"K4": lambda: sce.launch_supplychain_greedy(*k4),
             "K1 policy": lambda: scc.launch_supplychain_policy(
                 *k1, seed=seed, sample_major=True)}
    times = {k: {v: [] for v in libs} for k in calls}
    lib0 = _build._lib
    try:
        for _ in range(2):
            for v, lib in libs.items():
                _build._lib = lib
                for k, fn in calls.items():
                    times[k][v].append(_timed(fn, reps, dev)[0])
    finally:
        _build._lib = lib0
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
           "B": B, "hidden": list(HIDDEN),
           "protocol": f"median of {reps} after a warm-up, CUDA events; the "
                       "builds in turns, twice"}
    for k, t in times.items():
        med = {v: statistics.median(x) for v, x in t.items()}
        out[k] = {"runs_ms": t, "whole_ms": med["whole"]}
        if not whole:
            out[k].update(mlp_ms=med["whole"] - med["no_mlp"],
                          step_ms=med["whole"] - med["no_step"],
                          rest_ms=med["no_mlp"] + med["no_step"]
                          - med["whole"])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--whole", action="store_true",
                    help="time the built kernels alone, no variants")
    args = ap.parse_args(argv)
    out = run_benchmark(args.envs, args.reps, args.seed, args.whole)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
