"""Data parallelism and the federated meshes over ``torch.distributed``
(``fedvit_tpu/parallel/``): ``mesh`` builds the meshes and starts the ranks,
``data`` holds what a data-parallel train step needs."""
