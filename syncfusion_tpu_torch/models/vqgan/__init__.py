"""SpecVQGAN, the CondFoleyGen baseline's first stage: a VQ-GAN over mel
spectrograms (port of the inference side of ``syncfusion_tpu/models/vqgan``).
The discriminator, the LPAPS loss and the codebook trainer belong to the
baseline's training and are not ported yet."""
