from show_and_tell_tpu_torch.metrics.tokenizer import PTBTokenizer  # noqa: F401
from show_and_tell_tpu_torch.metrics.bleu import Bleu  # noqa: F401
from show_and_tell_tpu_torch.metrics.cider import Cider  # noqa: F401
from show_and_tell_tpu_torch.metrics.rouge import Rouge  # noqa: F401
from show_and_tell_tpu_torch.metrics.meteor import Meteor  # noqa: F401
from show_and_tell_tpu_torch.metrics.spice import Spice  # noqa: F401
from show_and_tell_tpu_torch.metrics.coco import COCO  # noqa: F401
from show_and_tell_tpu_torch.metrics.orchestrator import COCOEvalCap  # noqa: F401
