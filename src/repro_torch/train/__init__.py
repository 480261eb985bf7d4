"""Training support: the AdamW optimizer Phi is fit with, and the recsys
serve-step factories (``train_step``)."""
