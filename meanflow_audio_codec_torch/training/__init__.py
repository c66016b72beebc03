"""Training: the token adapter, the iMF objective, the optimiser and train
state, the train step and chunk, and the trainer with its checkpoints,
logging and profiling."""
