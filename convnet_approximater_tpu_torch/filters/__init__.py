from .filters import (FILTER, DenseKxKFilter, DepthwiseConvFilter, IndicesFilter,
                      KernelSizeFilter, ModuleFilter, SimpleConvFilter, build_filter)
