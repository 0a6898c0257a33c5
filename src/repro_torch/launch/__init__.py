"""Entry points: the serving CLI and the step builders it drives."""
