from show_and_tell_tpu_torch.obs.meters import StepTimer, ThroughputMeter  # noqa: F401
from show_and_tell_tpu_torch.obs.profiler import profile_trace  # noqa: F401
