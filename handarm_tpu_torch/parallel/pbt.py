"""Decentralized population-based training (counterpart of
handarm_tpu/parallel/pbt.py; IsaacGymEnvs' pbt/pbt.py and mutation.py).

N independent jobs share only a workspace directory. Each job periodically
- saves its own checkpoint and `meta.json` (frames, objective,
  hyperparameters, checkpoint file, time, policy index),
- reads the population's latest metadata (missing or torn entries count
  as absent),
- and, if it is in the bottom fraction and behind the best peers by both
  thresholds, adopts a top-fraction peer's checkpoint and mutates that
  peer's hyperparameters; the train entry point then restarts its process
  (`os.execv`) on them, as the reference does.

The workspace is the JAX package's, byte for byte in its layout and
`meta.json`: `<workspace>/policy_<ii>/pbt_<frames>.npz` and `meta.json`,
`<workspace>/best/best_obj_..._policy<iii>_frame<f>_<frames>.npz` and its
`.json`. Checkpoints are in the JAX package's format (`utils.checkpoint`),
so a workspace either package wrote is read by the other. The port writes
its checkpoint before the `meta.json` that names it (the JAX package writes
it on a background thread), and no `.tree` file.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

from handarm_tpu_torch.utils.checkpoint import load_train_state, save_checkpoint


@dataclass
class PbtConfig:
    workspace: str = "pbt_workspace"
    policy_idx: int = 0
    num_policies: int = 8
    interval_steps: int = 10_000_000
    # a policy must be within this fraction of frames of a peer to compare
    frames_slack: float = 0.7
    replace_fraction_best: float = 0.3
    replace_fraction_worst: float = 0.125
    # objective must differ by this margin (absolute + relative) to replace
    replace_threshold_abs: float = 0.05
    replace_threshold_rel: float = 0.05
    mutation_rate: float = 0.15
    change_range: tuple = (1.1, 1.5)
    mutable: dict = field(
        default_factory=lambda: {
            # hyperparameter name -> 'perturb'
            "learning_rate": "perturb",
            "e_clip": "perturb",
            "kl_threshold": "perturb",
            "entropy_coef": "perturb",
            "reward_scale": "perturb",
        }
    )


def _policy_dir(cfg: PbtConfig, idx: int) -> str:
    return os.path.join(cfg.workspace, f"policy_{idx:02d}")


def save_pbt_checkpoint(cfg: PbtConfig, train_state, hparams: dict, frames: int,
                        objective: float, seed: int = 0, ppo_cfg=None, env_cfg=None):
    """Write this policy's checkpoint, then the `meta.json` naming it
    (atomically: `.tmp`, then `os.replace`), and keep the newest 3
    checkpoints (reference safe_save, pbt.py:42). `ppo_cfg` and `env_cfg`
    as `save_checkpoint`'s `cfg` and `env_cfg`."""
    d = _policy_dir(cfg, cfg.policy_idx)
    os.makedirs(d, exist_ok=True)
    path = save_checkpoint(d, train_state, step=frames, name="pbt", seed=seed, sync=True,
                           cfg=ppo_cfg, env_cfg=env_cfg)
    meta = dict(
        frames=int(frames),
        objective=float(objective),
        hparams=hparams,
        checkpoint=os.path.basename(path),
        timestamp=time.time(),
        policy_idx=cfg.policy_idx,
    )
    tmp = os.path.join(d, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(d, "meta.json"))
    _prune_old(d, keep=3)


def _prune_old(d: str, keep: int):
    ckpts = sorted(
        (f for f in os.listdir(d) if f.startswith("pbt_") and f.endswith(".npz")),
        key=lambda f: int(f.rsplit("_", 1)[1].split(".")[0]),
    )
    for f in ckpts[:-keep]:
        for suffix in ("", ".tree"):  # the JAX package writes a .tree beside each
            try:
                os.remove(os.path.join(d, f + suffix))
            except FileNotFoundError:
                pass


def load_population(cfg: PbtConfig) -> list[dict | None]:
    """Best-effort read of every policy's latest metadata: a missing or torn
    entry is None (reference pbt.py:530-563)."""
    out = []
    for i in range(cfg.num_policies):
        meta_path = os.path.join(_policy_dir(cfg, i), "meta.json")
        try:
            with open(meta_path) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            out.append(None)
    return out


def mutate(hparams: dict, cfg: PbtConfig, rng: np.random.Generator) -> dict:
    """Perturb a random subset of mutable hyperparameters (reference
    mutation.py:81-107)."""
    new = dict(hparams)
    for key, kind in cfg.mutable.items():
        if key not in new or rng.random() > cfg.mutation_rate:
            continue
        if kind == "perturb":
            factor = rng.uniform(*cfg.change_range)
            if rng.random() < 0.5:
                factor = 1.0 / factor
            new[key] = float(new[key]) * factor
    return new


def pbt_step(cfg: PbtConfig, train_state, hparams: dict, frames: int, objective: float,
             rng: np.random.Generator | None = None, device="cpu", seed: int = 0,
             ppo_cfg=None, env_cfg=None):
    """One PBT exchange. Returns (train_state, hparams, restarted: bool); on
    a restart, the donor's whole TrainState read from its checkpoint onto
    `device`. Call every `interval_steps` env frames (reference
    PbtAlgoObserver.after_steps, pbt.py:269)."""
    rng = rng or np.random.default_rng()
    save_pbt_checkpoint(cfg, train_state, hparams, frames, objective, seed, ppo_cfg, env_cfg)
    pop = load_population(cfg)
    mine = pop[cfg.policy_idx]
    if mine is None:
        return train_state, hparams, False

    # peers that have seen comparable experience
    peers = [
        p for p in pop
        if p is not None and p["frames"] >= cfg.frames_slack * frames
    ]
    if len(peers) < max(2, int(0.5 * cfg.num_policies)):
        return train_state, hparams, False
    objectives = sorted(p["objective"] for p in peers)
    n = len(objectives)
    worst_cut = objectives[max(0, int(np.ceil(cfg.replace_fraction_worst * n)) - 1)]
    best_rank = max(1, int(np.floor(cfg.replace_fraction_best * n)))
    best_peers = sorted(peers, key=lambda p: -p["objective"])[:best_rank]
    best = best_peers[0]["objective"]

    behind_abs = best - objective > cfg.replace_threshold_abs
    behind_rel = objective < best - abs(best) * cfg.replace_threshold_rel
    am_worst = objective <= worst_cut
    if not (am_worst and behind_abs and behind_rel):
        return train_state, hparams, False

    donor = best_peers[int(rng.integers(len(best_peers)))]
    if donor["policy_idx"] == cfg.policy_idx:
        return train_state, hparams, False
    ckpt = os.path.join(_policy_dir(cfg, donor["policy_idx"]), donor["checkpoint"])
    try:
        new_state = load_train_state(ckpt, device, cfg=ppo_cfg, env_cfg=env_cfg)
    except (OSError, ValueError, KeyError, NotImplementedError):
        # a donor file gone (pruned), torn or of another layout: no exchange
        return train_state, hparams, False
    new_hparams = mutate(dict(donor["hparams"]), cfg, rng)
    return new_state, new_hparams, True


def maybe_save_best_policy(cfg: PbtConfig, train_state, objective: float, frames: int,
                           keep: int = 6, seed: int = 0, ppo_cfg=None, env_cfg=None) -> bool:
    """Population-wide best-policy archive (reference pbt.py:564-610
    _maybe_save_best_policy): copy this policy's state into
    <workspace>/best/ iff its objective beats every archived one; keep the
    `keep` most recent archive entries. Returns True if archived."""
    d = os.path.join(cfg.workspace, "best")
    os.makedirs(d, exist_ok=True)
    best_so_far = -float("inf")
    metas = sorted(f for f in os.listdir(d) if f.endswith(".json"))
    for f in metas:
        try:
            with open(os.path.join(d, f)) as fh:
                best_so_far = max(best_so_far, float(json.load(fh)["objective"]))
        except (OSError, ValueError, KeyError):
            continue
    if objective <= best_so_far:
        return False
    name = (
        f"best_obj_{objective:015.5f}_policy{cfg.policy_idx:03d}"
        f"_frame{int(frames):012d}"
    )
    path = save_checkpoint(d, train_state, step=int(frames), name=name, seed=seed, sync=True,
                           cfg=ppo_cfg, env_cfg=env_cfg)
    with open(os.path.join(d, name + ".json"), "w") as fh:
        json.dump(
            dict(
                objective=float(objective),
                frames=int(frames),
                policy_idx=cfg.policy_idx,
                checkpoint=os.path.basename(path),
            ),
            fh,
        )
    # prune: keep only the `keep` newest archive entries
    entries = sorted(
        (f for f in os.listdir(d) if f.endswith(".json")), reverse=True
    )
    for f in entries[keep:]:
        stem = f[: -len(".json")]
        for g in os.listdir(d):
            if g.startswith(stem):
                try:
                    os.remove(os.path.join(d, g))
                except FileNotFoundError:
                    pass
    return True
