from nezha_tpu_torch.data.mnist import load_mnist, mnist_batches
from nezha_tpu_torch.data.synthetic import (synthetic_image_batches,
                                            synthetic_mlm_batches,
                                            synthetic_token_batches)

__all__ = ["load_mnist", "mnist_batches", "synthetic_image_batches",
           "synthetic_mlm_batches", "synthetic_token_batches"]
