"""Training support: the AdamW optimizer Phi is fit with."""
