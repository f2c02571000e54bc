"""Class-activation maps (port of ``convnet_approximater_tpu/visualization/``)."""

from .cam import (CAM_METHODS, ablationcam, eigencam, eigengradcam, fullgrad, fullgrad_terms,
                  gradcam, gradcam_elementwise, gradcam_pp, hirescam, layercam, scorecam,
                  xgradcam)
