"""Training layer of the port: losses, schedules, the AdamW step,
checkpoints and the three trainers (``loops``)."""

from .checkpoint import restore_train_state, save_train_state  # noqa: F401
from .loss import (  # noqa: F401
    masked_cross_entropy,
    masked_cross_entropy_sum,
    shifted_token_loss,
    shifted_token_loss_sum,
)
from .schedule import cosine, warmup_cosine  # noqa: F401
from .step import (  # noqa: F401
    TrainState,
    init_state,
    make_accum_train_step,
    make_optimizer,
    make_sharded_train_step,
    make_train_step,
    shard_state,
    whisper_loss_fn,
    whisper_sum_loss_fn,
)
