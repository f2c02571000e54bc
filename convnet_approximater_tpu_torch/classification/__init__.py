from .validate import AverageMeter, RealLabelsSets, ValidateHelper, accuracy_sums, eval_batch
from .train import TrainHelper, ema_update
