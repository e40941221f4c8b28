"""Training: the optimizer and its schedules, the train state, the train
and eval steps, and the trainer."""
