"""Reward models of the port."""
from repro_torch.rewards.prm import PRM, OracleRewardModel  # noqa: F401
