

def test_channel_axis_layout_parity():
    """update(channel_axis=1) on [B, C, A] == update on [B, A, C]
    (the layout used by the detection train step)."""
    import jax.numpy as jnp
    import numpy as np

    from papc_tpu.train.running_metrics import (
        AccuracyState,
        PrecisionRecallState,
    )

    rng = np.random.RandomState(0)
    for ncls, ebz in ((1, True), (3, True), (3, False)):
        preds = jnp.asarray(rng.randn(2, 50, ncls).astype(np.float32))
        labels = jnp.asarray(rng.randint(-1, ncls + 1, size=(2, 50)))
        preds_ca = preds.transpose(0, 2, 1)
        for use_sig in (True, False):
            a1 = AccuracyState.create().update(
                labels, preds, use_sigmoid_score=use_sig,
                encode_background_as_zeros=ebz,
            )
            a2 = AccuracyState.create().update(
                labels, preds_ca, use_sigmoid_score=use_sig,
                encode_background_as_zeros=ebz, channel_axis=1,
            )
            np.testing.assert_allclose(float(a1.value), float(a2.value))
            p1 = PrecisionRecallState.create().update(
                labels, preds, use_sigmoid_score=use_sig,
                encode_background_as_zeros=ebz,
            )
            p2 = PrecisionRecallState.create().update(
                labels, preds_ca, use_sigmoid_score=use_sig,
                encode_background_as_zeros=ebz, channel_axis=1,
            )
            np.testing.assert_allclose(
                np.asarray(p1.tp), np.asarray(p2.tp)
            )
            np.testing.assert_allclose(
                np.asarray(p1.fp), np.asarray(p2.fp)
            )
