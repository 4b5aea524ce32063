from vpt_tpu_torch.agent.agent import MineRLAgent
from vpt_tpu_torch.agent.idm import IDM_REQUIRED_RESOLUTION, IDMAgent, StreamingIDMLabeler, action_jsonl_row

__all__ = ["MineRLAgent", "IDMAgent", "StreamingIDMLabeler", "IDM_REQUIRED_RESOLUTION", "action_jsonl_row"]
