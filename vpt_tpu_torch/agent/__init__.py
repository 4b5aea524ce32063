from vpt_tpu_torch.agent.agent import MineRLAgent

__all__ = ["MineRLAgent"]
