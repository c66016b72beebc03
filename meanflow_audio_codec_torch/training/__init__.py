"""Training-side helpers the codec shares (the token adapter)."""
