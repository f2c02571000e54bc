from .depth_separable_conv import CascadeConv, FixPaddingBias, ParallelConv
from .drop import DropPath, drop_path
from .msca import MSCA, MSCAProfile
from .substitution import LAYER, Substitution, build_layer
