from .dist import (make_mesh, render_image_sharded,  # noqa: F401
                   render_image_sharded_fast, grad_step_sharded)
from .launch import initialize, pod_mesh, is_coordinator, gather_image  # noqa: F401
