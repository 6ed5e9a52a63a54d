"""Config keys and defaults (counterpart of
``deepspeed_tpu/runtime/constants.py``)."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

ADAMW_OPTIMIZER = "adamw"
# the 1-bit optimizers (not ported: the config raises on them)
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"

# loss scaling
FP16_LOSS_SCALE_DEFAULT = 0  # 0 => dynamic
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE_DEFAULT = 1.0

GRADIENT_CLIPPING_DEFAULT = 0.0
STEPS_PER_PRINT_DEFAULT = 10
