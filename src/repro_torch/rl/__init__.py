"""The training plane: GRPO, AdamW, the rollout service and the trainer."""
