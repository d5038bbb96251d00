"""Example programs of the port: the magic-series counts.

Run each as a module from the repository root, on the CUDA card by default:

    python -m sventt_tpu_torch.examples.magic_series 10
    python -m sventt_tpu_torch.examples.magic_series_crosscheck 30
    python -m sventt_tpu_torch.examples.magic_series_reference_scale 100

``--device cpu`` runs them on the CPU (every kernel's plain version), for
small m.
"""
