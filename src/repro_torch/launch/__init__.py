"""Entry points: the serving and CNN-training CLIs and the step builders they drive."""
