from .depth_separable_conv import CascadeConv, FixPaddingBias, FixPaddingBias2d, ParallelConv
from .drop import DropPath, drop_generator, drop_path
from .dummy import DummyLayer
from .low_rank_conv import (LowRankExpConvV1, LowRankExpConvV2, LowRankExpConvV3,
                            LowRankExpConvV4, SeparableConv)
from .merged_ffn import MergedFFN
from .msca import MSCA, MSCAProfile
from .quant import (QATConv2d, QATLinear, QuantConv2d, QuantLinear, fake_quant,
                    fake_quant_weight)
from .simple_conv import SimpleConv
from .substitution import (LAYER, Substitution, build_layer, forced_branch, release_taps,
                           taps)
