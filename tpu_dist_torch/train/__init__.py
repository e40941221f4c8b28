"""Training on one device: the optimizer and its schedules, the train state,
and the train and eval steps."""
