"""SpecVQGAN, the CondFoleyGen baseline's first stage: a VQ-GAN over mel
spectrograms (port of ``syncfusion_tpu/models/vqgan``): the model, its
quantizer, LPAPS and the discriminator of its training, and ``convert``,
the reference SpecVQGAN and minGPT checkpoints' converters."""
