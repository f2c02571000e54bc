from .approximater import APP, Approximater, build_app
from .dummy import Dummy
from .dw_sep_rep import DwSepRep
from .ffn_prune import AttnPrune, FfnPrune, MlpPrune
from .ffn_rep import FfnRep, merged_ffn_solve
from .low_rank_exp import LowRankExpV1, LowRankExpV2, LowRankExpV3, LowRankExpV4
from .msca_rep import (MscaProfile, MscaRep, MscaRepProfile, get_equivalent_kernel,
                       merge_res, sum_bias)
