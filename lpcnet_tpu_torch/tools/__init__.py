"""The port's counterparts of the repo's tools/ scripts that drive the JAX
package: the held-out quality evaluations of the shipped artifacts
(eval_lpcnet, eval_plc, eval_dred) and the artifact fits (train_codebooks,
fit_pade). Each runs as `python -m lpcnet_tpu_torch.tools.<name>` with the
JAX script's arguments and --device (default: the card)."""
