"""Training: the loss (``loss``) and the train step (``step``)."""
