"""The port's user entry points, one module per workflow of the JAX
package's examples/ folder:

    python -m coati_tpu_torch.examples.<name> [arguments] [--device cpu]

tutorial, chembl_analysis, coati2_tutorial, generation_examples,
metadynamics_example, finetune_lora, serve, train_grande, train_coati2.
Each takes its JAX counterpart's arguments plus --device, runs on the
CUDA card unless --device names another (without a card and without
--device it raises; it never falls back to the CPU), and has
main(argv=None) -> dict, which returns the numbers it prints."""

DEVICE_HELP = "torch device to run on (default: the CUDA card; 'cpu' only when asked)"
