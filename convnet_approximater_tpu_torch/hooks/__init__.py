from .calibration import CalibrationHook, calibrate, site_statistic
from .checkpoint import CkptHook
from .class_eval_hook import ClassEvalHook
from .finetune import CheckpointSaver, L2Reconstruct, make_optimizer
from .fps import Fps
from .hook import HOOK, Hook, build_hook
from .inference_time_hook import (InferenceTimeHook, eager_times, forward_seconds, forward_times,
                                  graph_ms, time_forward)
from .low_rank_exp_v1_decomp import LowRankExpV1Decomp
from .model_analysis import ModelAnalysis, count_macs, count_params
from .priority import Priority, get_priority
from .qat import PrepareQAT

# registers SegL2Reconstruct; imported last, since it builds on the hooks above
import convnet_approximater_tpu_torch.segmentation.finetune  # noqa: E402,F401
