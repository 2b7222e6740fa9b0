"""Model zoo: dense/MoE/VLM transformer, Mamba2 SSD, Jamba hybrid,
whisper-style enc-dec, and the paper's autoencoder/MLP, as in
``repro.models``.  The reference's ``*_specs`` input stand-ins of its dry
run are not ported."""
from repro_torch.models.registry import build_model
from repro_torch.models.simple import (MLP, ae_loss_fn, autoencoder,
                                       classifier_loss_fn)

__all__ = ['build_model', 'MLP', 'autoencoder', 'ae_loss_fn',
           'classifier_loss_fn']
