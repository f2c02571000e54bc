from .validate import AverageMeter, RealLabelsSets, ValidateHelper, accuracy_sums, eval_batch
