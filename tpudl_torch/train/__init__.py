"""Training of the port: the classification train step and loop (with
checkpointing and resume), its CUDA-graph capture (``compile_step``),
the mixed-precision policies (``precision``), the optimizer stack,
throughput accounting, the metrics logger (``logging``) and the
profile reader (``profiling``) (tpudl.train's single-device path)."""

from tpudl_torch.train.logging import MetricLogger  # noqa: F401

from tpudl_torch.train.loop import (  # noqa: F401
    CompiledStep,
    TrainState,
    compile_step,
    create_train_state,
    cross_entropy_loss,
    evaluate,
    finalize_zero_step_run,
    fit,
    make_classification_eval_step,
    make_classification_train_step,
    microbatch,
    pad_batch,
    resume_latest,
)
from tpudl_torch.train.optim import make_optimizer, make_schedule  # noqa: F401
from tpudl_torch.train.precision import (  # noqa: F401
    LossScaleConfig,
    PrecisionPolicy,
    policy,
    policy_from_env,
)
from tpudl_torch.train.profiling import (  # noqa: F401
    format_summary,
    summarize_trace,
)
