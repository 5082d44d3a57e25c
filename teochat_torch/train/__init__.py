"""LoRA adapters, the optimizer and train step, and the train driver."""
