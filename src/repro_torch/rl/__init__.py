from repro_torch.rl.gae import gae
from repro_torch.rl.nets import ActorCritic
from repro_torch.rl.policy_lm import LMLaneState, LMPolicy, build_lm_collect_fn
from repro_torch.rl.ppo import (
    PPOConfig,
    PPOState,
    make_ppo_update,
    make_vtrace_ppo_update,
    train,
    train_device,
    train_host,
    train_host_pipelined,
    train_pipelined,
)
from repro_torch.rl.vtrace import VTraceReturns, vtrace

__all__ = ["ActorCritic", "LMLaneState", "LMPolicy", "PPOConfig",
           "PPOState", "VTraceReturns", "build_lm_collect_fn", "gae",
           "make_ppo_update", "make_vtrace_ppo_update", "train",
           "train_device", "train_host", "train_host_pipelined",
           "train_pipelined", "vtrace"]
