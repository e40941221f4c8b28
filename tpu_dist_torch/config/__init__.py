"""The training configuration and its command-line flags."""
