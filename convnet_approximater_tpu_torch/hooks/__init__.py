from .hook import HOOK, Hook, build_hook
from .inference_time_hook import InferenceTimeHook, time_forward
from .priority import Priority, get_priority
