"""Model zoo: dense/MoE/VLM transformer, Mamba2 SSD, Jamba hybrid,
whisper-style enc-dec, and the paper's autoencoder/MLP, as in
``repro.models``, with the dry run's input stand-ins (``*_specs``)."""
from repro_torch.models.registry import (build_model, decode_specs,
                                         prefill_batch_specs,
                                         train_batch_specs)
from repro_torch.models.simple import (MLP, ae_loss_fn, autoencoder,
                                       classifier_loss_fn)

__all__ = ['build_model', 'MLP', 'autoencoder', 'ae_loss_fn',
           'classifier_loss_fn', 'decode_specs', 'prefill_batch_specs',
           'train_batch_specs']
