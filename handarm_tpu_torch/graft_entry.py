"""The flagship forward step as a callable (counterpart of `entry()` of the
repository's __graft_entry__.py).

`entry()` returns `(forward_step, (env_state, obs))`: one UR5+SIH lift env
step driven by the PPO policy's deterministic action, for 64 envs with
25-step episodes, 8 solver sweeps and a PPO learner of horizon 4,
minibatch 128 and one mini-epoch from a flax-default init. forward_step
(env_state, obs) -> (env_state, obs, reward, done).
"""

from __future__ import annotations

from handarm_tpu_torch.envs.hand_arm import HandArmConfig, HandArmEnv
from handarm_tpu_torch.learn.ppo import PPO, PPOConfig


def build(device=None):
    """(env, PPO, TrainState) of the entry's workload."""
    env = HandArmEnv(HandArmConfig(num_envs=64, episode_length=25, solver_iterations=8), device)
    ppo = PPO(env, PPOConfig(horizon=4, minibatch_size=128, mini_epochs=1))
    return env, ppo, ppo.init(0)


def make_forward_step(env, ppo, ts):
    """One policy-in-the-loop env step of `ts`'s policy."""
    def forward_step(env_state, obs):
        state, res = env.step(env_state, ppo.act(ts, obs, deterministic=True))
        return state, res.obs, res.reward, res.done

    return forward_step


def entry(device=None):
    """(forward_step, (env_state, obs)) on `device` (default: cuda)."""
    env, ppo, ts = build(device=device)
    return make_forward_step(env, ppo, ts), (ts.env_state, ts.last_obs)
