"""Parallel paths on ``torch.distributed``: one process per rank, each
holding its own shard (parallel/mesh.py says how this maps the JAX
package's single-controller mesh)."""

from fmcw_radar_processing_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
)
from fmcw_radar_processing_tpu_torch.parallel.sharded_chain import (  # noqa: F401
    make_sharded_frame_chain,
)
from fmcw_radar_processing_tpu_torch.parallel.sharded_stft import (  # noqa: F401
    ShardedStft,
)
from fmcw_radar_processing_tpu_torch.parallel.pp_chain import (  # noqa: F401
    STAGE_AXIS,
    make_pp_frame_chain,
    make_pp_mesh,
)
from fmcw_radar_processing_tpu_torch.parallel.tp_chain import (  # noqa: F401
    make_tp_frame_chain,
)
