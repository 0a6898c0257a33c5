"""Optimizers: functional Adam/AdamW over the port's param trees."""
