"""Serving and training across processes (port of
``convnet_approximater_tpu/parallel/``): one process per device on
``torch.distributed``, the ``(data, model)`` mesh, GPipe pipelines inside a
stage (in training too) and over the whole model, tensor parallelism over
the model axis (``tp.py``, ``tp_layers.py``), spatial sharding of eval
forwards over the model axis (``spatial.py``: image rows and halo
exchanges), and the data axis's reductions in training."""

from .data_parallel import (PipeAxis, all_gather_rows, any_rank, average_gradients,
                            broadcast_gradients, pipe_axis, replicate_from_root, sum_over,
                            training_axis, training_mesh)
from .distributed import (MESH_TODO, initialize_distributed, is_main_process,
                          local_device_count, process_count, shutdown_distributed)
from .mesh import (DATA_AXIS, MODEL_AXIS, SpatialSharding, batch_sharding, broadcast_module,
                   make_mesh, pad_indices, pad_to_multiple, param_shardings, replicate,
                   shard_batch, shard_indices, shard_rows, spatial_sharding)
from .pp import owned_range, pipeline_blocks, pipeline_blocks_train, release, restore
from .tp import resolve_tp_rules, shard_module, unshard_module
from .spatial import (gather_spatial, global_mean, is_spatial, shard_spatial, spatial_module,
                      unspatial_module)
from .pp_model import (ModelPipeline, Tail, Unit, build_model_pipeline, partition_units, subtree,
                       unit_from_module)
