"""The training path: losses, schedules, optimizers, the task, checkpoints, the loop."""
