"""Program bookkeeping (counterpart of ``mx_rcnn_tpu/compile``): which
(kind, shape) programs a process has dispatched, and what each one's
first dispatch cost (:class:`~mx_rcnn_tpu_torch.compile.registry.
ProgramRegistry`)."""

from mx_rcnn_tpu_torch.compile.registry import ProgramRegistry, config_digest

__all__ = ["ProgramRegistry", "config_digest"]
