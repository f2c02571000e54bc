"""The conv-FFN with fc1 (1x1) and the depthwise k x k conv merged into one
dense k x k conv (port of ``convnet_approximater_tpu/layers/merged_ffn.py``).

In MSCAN's FFN, fc1 and dconv are adjacent linear maps (GELU comes after the
depthwise conv), so ``dconv(fc1(x))`` is one dense k x k conv with kernel
``W[m, i, dy, dx] = D[m, dy, dx] W1[m, i]`` and bias ``b1 sum(D) + bd``, exact
away from the borders; :class:`FixPaddingBias2d` corrects the frame.  FfnRep
(``core/ffn_rep.py``) solves both in closed form.  The JAX package made it to
fill the TPU's matrix unit with a thin reduction; on this card in float32 the
merged conv does 9 times fc1's multiply-accumulates.
"""

from __future__ import annotations

from torch import nn

from convnet_approximater_tpu_torch.nn import Conv2d, Dropout, Identity, gelu

from .depth_separable_conv import FixPaddingBias2d
from .substitution import LAYER


@LAYER.register_module()
class MergedFFN(nn.Module):
    """Dense ``k x k`` conv (= fc1 then dconv) -> border fix -> GELU -> fc2 -> dropout."""

    def __init__(self, num_channel: int, hidden_channel: int, drop: float = 0.0,
                 kernel_size: int = 3, fix: bool = True):
        super().__init__()
        self.num_channel = num_channel
        self.hidden_channel = hidden_channel
        self.kernel_size = kernel_size
        self.conv = Conv2d(num_channel, hidden_channel, kernel_size, padding=kernel_size // 2)
        self.fix = FixPaddingBias2d(hidden_channel, kernel_size // 2) if fix else Identity()
        self.fc2 = Conv2d(hidden_channel, num_channel, 1)
        self.drop = Dropout(drop)

    def forward(self, x):
        return self.drop(self.fc2(gelu(self.fix(self.conv(x)))))
