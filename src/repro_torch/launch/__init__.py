"""Entry points: the serving, CNN-training and LM-training CLIs and the step functions they run."""
