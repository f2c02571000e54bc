from .config import Config, get_cfg, init_cfg, print_cfg, save_cfg, update_cfg
from .logger import build_logger, get_logger, get_rank
from .registry import Registry, build_from_cfg
from .serialize import (flatten_tree, load_ckpt, load_flat, save_model, tree_get,
                        tree_set, unflatten_tree)
