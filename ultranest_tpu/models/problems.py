# noqa: D400 D205
"""Analytic benchmark problems in paired numpy/jax form."""

import numpy as np

__all__ = ['Problem', 'gauss', 'multigauss', 'asymgauss', 'corrgauss',
           'eggbox', 'rosenbrock', 'multishell', 'shell', 'loggamma',
           'funnel', 'pyramid', 'sine', 'corrpeak', 'hyperrect',
           'dirichlet']


class Problem:
    """An analytic inference problem.

    Attributes
    ----------
    name: str
    param_names: list of str
    loglike, transform: numpy vectorized functions
    jax_loglike, jax_transform: jax jittable functions (or None)
    logz: float or None
        analytic log-evidence, if known
    """

    def __init__(self, name, param_names, loglike, transform,
                 jax_loglike=None, jax_transform=None, logz=None):
        self.name = name
        self.param_names = param_names
        self.loglike = loglike
        self.transform = transform
        self.jax_loglike = jax_loglike
        self.jax_transform = jax_transform
        self.logz = logz

    @property
    def ndim(self):
        """Dimensionality of the problem."""
        return len(self.param_names)

    def sampler_kwargs(self, use_jax=True, **extra):
        """Keyword arguments for ReactiveNestedSampler."""
        kw = dict(param_names=self.param_names, loglike=self.loglike,
                  transform=self.transform, vectorized=True)
        if use_jax and self.jax_loglike is not None:
            kw['jax_loglike'] = self.jax_loglike
            kw['jax_transform'] = self.jax_transform
        kw.update(extra)
        return kw


def _names(ndim):
    return ['param%d' % (i + 1) for i in range(ndim)]


def gauss(ndim=3, sigma=0.1):
    """Centered isotropic gaussian (cf. reference docs/gauss.py)."""
    import jax.numpy as jnp
    sigma_np = float(sigma)
    norm = -0.5 * np.log(2 * np.pi * sigma_np**2) * ndim

    def loglike(theta):
        return -0.5 * (((theta - 0.5) / sigma_np) ** 2).sum(axis=1) + norm

    def jax_loglike(theta):
        return -0.5 * (((theta - 0.5) / sigma_np) ** 2).sum(axis=1) + norm

    # evidence = integral over unit cube of the normalized gaussian ~ 1
    # (edge truncation negligible for sigma << 0.5)
    return Problem('gauss%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=0.0)


def multigauss(ndim=2, sigma=0.05, centers=(0.3, 0.7)):
    """Bimodal gaussian mixture along all axes."""
    import jax.numpy as jnp
    c1, c2 = centers
    norm = -0.5 * np.log(2 * np.pi * sigma**2) * ndim - np.log(2.0)

    def loglike(theta):
        a = -0.5 * (((theta - c1) / sigma) ** 2).sum(axis=1)
        b = -0.5 * (((theta - c2) / sigma) ** 2).sum(axis=1)
        return np.logaddexp(a, b) + norm

    def jax_loglike(theta):
        a = -0.5 * (((theta - c1) / sigma) ** 2).sum(axis=1)
        b = -0.5 * (((theta - c2) / sigma) ** 2).sum(axis=1)
        return jnp.logaddexp(a, b) + norm

    # two modes, each weight 1/2, each integrating to ~1 over the cube
    return Problem('multigauss%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=0.0)


def asymgauss(ndim=50, sigma_min=0.01):
    """Axis-wise log-spaced widths gaussian (reference examples/testasymgauss.py)."""
    import jax.numpy as jnp
    sigma = np.logspace(-1, np.log10(sigma_min), ndim)
    width = np.clip(1 - 5 * sigma, 1e-20, None)
    centers = (np.sin(np.arange(ndim) / 2.0) * width + 1.0) / 2.0
    norm = -0.5 * np.log(2 * np.pi * sigma**2).sum()
    sigma_j = None

    def loglike(theta):
        return -0.5 * (((theta - centers) / sigma) ** 2).sum(axis=1) + norm

    def jax_loglike(theta):
        return -0.5 * (((theta - jnp.asarray(centers))
                        / jnp.asarray(sigma)) ** 2).sum(axis=1) + norm

    return Problem('asymgauss%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=0.0)


def corrgauss(ndim=4, rho=0.95, sigma=0.1):
    """Strongly correlated gaussian."""
    import jax.numpy as jnp
    cov = np.full((ndim, ndim), rho) + np.eye(ndim) * (1 - rho)
    cov *= sigma**2
    invcov = np.linalg.inv(cov)
    norm = -0.5 * (np.linalg.slogdet(2 * np.pi * cov)[1])

    def loglike(theta):
        d = theta - 0.5
        return -0.5 * (d @ invcov * d).sum(axis=1) + norm

    def jax_loglike(theta):
        d = theta - 0.5
        return -0.5 * jnp.einsum('ij,jk,ik->i', d, jnp.asarray(invcov),
                                 d, precision='highest') + norm

    return Problem('corrgauss%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=0.0)


def _eggbox_logz():
    n = 4000
    x = (np.arange(n) + 0.5) / n * 10 * np.pi
    chi = np.outer(np.cos(x / 2), np.cos(x / 2))
    logl = (2 + chi) ** 5
    m = logl.max()
    return float(np.log(np.exp(logl - m).mean()) + m)


def eggbox():
    """2-d eggbox, 18 modes (reference examples/testeggbox.py)."""
    import jax.numpy as jnp

    def loglike(z):
        chi = np.cos(z[:, 0] / 2) * np.cos(z[:, 1] / 2)
        return (2 + chi) ** 5

    def transform(x):
        return x * 10 * np.pi

    def jax_loglike(z):
        chi = jnp.cos(z[:, 0] / 2) * jnp.cos(z[:, 1] / 2)
        return (2 + chi) ** 5

    def jax_transform(x):
        return x * 10 * jnp.pi

    return Problem('eggbox', ['x', 'y'], loglike, transform,
                   jax_loglike, jax_transform, logz=_eggbox_logz())


def rosenbrock(ndim=2):
    """Rosenbrock valley (reference examples/testrosenbrock.py)."""
    import jax.numpy as jnp

    def loglike(theta):
        a = theta[:, :-1]
        b = theta[:, 1:]
        return -2 * (100 * (b - a**2)**2 + (1 - a)**2).sum(axis=1)

    def transform(u):
        return u * 20 - 10

    def jax_loglike(theta):
        a = theta[:, :-1]
        b = theta[:, 1:]
        return -2 * (100 * (b - a**2)**2 + (1 - a)**2).sum(axis=1)

    def jax_transform(u):
        return u * 20 - 10

    return Problem('rosenbrock%dd' % ndim, _names(ndim), loglike, transform,
                   jax_loglike, jax_transform, logz=None)


def _shell_vol(ndim, r, w):
    import scipy.special
    import scipy.stats
    mom = scipy.stats.norm.moment(ndim - 1, loc=r, scale=w)
    vol = np.pi**(ndim / 2.0) / scipy.special.gamma(ndim / 2.0 + 1)
    surf = vol * ndim
    return mom * surf


def multishell(ndim=2, r=0.2, w=None):
    """Two overlapping gaussian shells (reference examples/testmultishell.py)."""
    import jax.numpy as jnp
    if w is None:
        w = 0.001 / ndim
    c1 = np.zeros(ndim) + 0.5
    c2 = np.zeros(ndim) + 0.5
    c1[0] -= r / 2
    c2[0] += r / 2
    N = -0.5 * np.log(2 * np.pi * w**2)
    logz = float(np.log(_shell_vol(ndim, r, w) + _shell_vol(ndim, r, w)))

    def loglike(theta):
        d1 = ((theta - c1)**2).sum(axis=1)**0.5
        d2 = ((theta - c2)**2).sum(axis=1)**0.5
        L1 = -0.5 * ((d1 - r)**2) / w**2 + N
        L2 = -0.5 * ((d2 - r)**2) / w**2 + N
        return np.logaddexp(L1, L2)

    def jax_loglike(theta):
        d1 = jnp.sqrt(((theta - jnp.asarray(c1))**2).sum(axis=1))
        d2 = jnp.sqrt(((theta - jnp.asarray(c2))**2).sum(axis=1))
        L1 = -0.5 * ((d1 - r)**2) / w**2 + N
        L2 = -0.5 * ((d2 - r)**2) / w**2 + N
        return jnp.logaddexp(L1, L2)

    return Problem('multishell%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=logz)


def shell(ndim=2, r=0.2, w=0.004):
    """Single gaussian shell."""
    import jax.numpy as jnp
    c = np.zeros(ndim) + 0.5
    N = -0.5 * np.log(2 * np.pi * w**2)
    logz = float(np.log(_shell_vol(ndim, r, w)))

    def loglike(theta):
        d = ((theta - c)**2).sum(axis=1)**0.5
        return -0.5 * ((d - r)**2) / w**2 + N

    def jax_loglike(theta):
        d = jnp.sqrt(((theta - jnp.asarray(c))**2).sum(axis=1))
        return -0.5 * ((d - r)**2) / w**2 + N

    return Problem('shell%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=logz)


def loggamma(ndim=30, scale=1.0 / 30):
    """Mixture of loggamma and normal components (reference examples/testloggamma.py).

    Heavy-tailed, multimodal in the first two axes; the standard hard
    problem for step samplers. Analytic logZ ~ 0 (densities normalized,
    negligible truncation).
    """
    import scipy.stats
    rv1a = scipy.stats.loggamma(1, loc=2.0 / 3, scale=scale)
    rv1b = scipy.stats.loggamma(1, loc=1.0 / 3, scale=scale)
    rv2a = scipy.stats.norm(2.0 / 3, scale)
    rv2b = scipy.stats.norm(1.0 / 3, scale)
    rv_rest = []
    for i in range(2, ndim):
        if i <= (ndim + 2) / 2:
            rv_rest.append(scipy.stats.loggamma(1, loc=2.0 / 3.0, scale=scale))
        else:
            rv_rest.append(scipy.stats.norm(2.0 / 3, scale))

    def loglike(theta):
        L1 = np.log(0.5 * rv1a.pdf(theta[:, 0])
                    + 0.5 * rv1b.pdf(theta[:, 0]) + 1e-300)
        L2 = np.log(0.5 * rv2a.pdf(theta[:, 1])
                    + 0.5 * rv2b.pdf(theta[:, 1]) + 1e-300)
        Lrest = np.sum([rv.logpdf(t) for rv, t
                        in zip(rv_rest, theta[:, 2:].transpose())], axis=0)
        return L1 + L2 + Lrest

    # jax version: loggamma(1) logpdf(x; loc, scale) = y - exp(y) - log(scale)
    # with y = (x - loc)/scale
    import jax.numpy as jnp
    import jax.scipy.stats as jstats
    locs_rest = np.array([2.0 / 3.0 if i <= (ndim + 2) / 2 else 2.0 / 3
                          for i in range(2, ndim)])
    is_lg_rest = np.array([i <= (ndim + 2) / 2 for i in range(2, ndim)])

    def _lg_logpdf(x, loc):
        y = (x - loc) / scale
        return y - jnp.exp(y) - np.log(scale)

    def _norm_logpdf(x, loc):
        return jstats.norm.logpdf(x, loc, scale)

    log_tiny = np.log(1e-300)

    def jax_loglike(theta):
        # the +1e-300 regularization of the reference clamps the tails
        L1 = jnp.logaddexp(
            jnp.logaddexp(_lg_logpdf(theta[:, 0], 2.0 / 3),
                          _lg_logpdf(theta[:, 0], 1.0 / 3)) + np.log(0.5),
            log_tiny)
        L2 = jnp.logaddexp(
            jnp.logaddexp(_norm_logpdf(theta[:, 1], 2.0 / 3),
                          _norm_logpdf(theta[:, 1], 1.0 / 3)) + np.log(0.5),
            log_tiny)
        rest = theta[:, 2:]
        lg = _lg_logpdf(rest, jnp.asarray(locs_rest))
        nm = _norm_logpdf(rest, jnp.asarray(locs_rest))
        Lrest = jnp.where(jnp.asarray(is_lg_rest)[None, :], lg, nm).sum(axis=1)
        return L1 + L2 + Lrest

    return Problem('loggamma%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=0.0)


def funnel(ndim=2, sigma0=0.2):
    """Neal-style funnel (reference examples/testfunnel.py flavour)."""
    import jax.numpy as jnp

    def loglike(theta):
        sigma = 10 ** (theta[:, 0] * 4 - 2) * sigma0
        like = -0.5 * ((theta[:, 1:] - 0.5)**2 / sigma[:, None]**2).sum(axis=1) \
            - 0.5 * np.log(2 * np.pi * sigma**2) * (theta.shape[1] - 1)
        return like

    def jax_loglike(theta):
        sigma = 10 ** (theta[:, 0] * 4 - 2) * sigma0
        like = -0.5 * ((theta[:, 1:] - 0.5)**2 / sigma[:, None]**2).sum(axis=1) \
            - 0.5 * jnp.log(2 * jnp.pi * sigma**2) * (theta.shape[1] - 1)
        return like

    return Problem('funnel%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=None)


def pyramid(ndim=2):
    """Pyramid: L = -max|theta - 0.5| (shrinkage-test problem)."""
    import jax.numpy as jnp

    def loglike(theta):
        return -np.abs(theta - 0.5).max(axis=1)

    def jax_loglike(theta):
        return -jnp.abs(theta - 0.5).max(axis=1)

    return Problem('pyramid%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=None)


def sine(ndata=40, contrast=100, seed=2):
    """Periodic signal fit with a circular phase parameter.

    Sinusoid amplitude/jitter/phase/period regression on synthetic
    data (reference examples/testsine.py); the phase axis is circular
    (``wrapped_params=[False, False, True, False]``).
    """
    import jax.numpy as jnp
    rng = np.random.RandomState(seed)
    jitter_true = 0.1
    amplitude_true = contrast / ndata * jitter_true
    period_true = 180.0
    x = rng.uniform(0, 360, ndata)
    y = rng.normal(amplitude_true * np.sin(x / period_true * 2 * np.pi),
                   jitter_true)

    def _predict(np_, amplitude, jitter, phase, period, xcol):
        model = amplitude * np_.sin(xcol / period * 2 * np_.pi + phase)
        return (-0.5 * np_.log(2 * np_.pi * jitter**2)
                - 0.5 * ((model - y.reshape((-1, 1))) / jitter)**2).sum(axis=0)

    def loglike(params):
        amplitude, jitter, phase, period = params.T[:4]
        return _predict(np, amplitude, jitter, phase, period,
                        x.reshape((-1, 1)))

    def jax_loglike(params):
        amplitude, jitter, phase, period = params.T[:4]
        return _predict(jnp, amplitude, jitter, phase, period,
                        jnp.asarray(x).reshape((-1, 1)))

    def transform(u):
        z = np.empty((len(u), 4))
        z[:, 0] = 10 ** (u[:, 0] * 4 - 2)
        z[:, 1] = 10 ** (u[:, 1] * 1 - 1.5)
        z[:, 2] = 2 * np.pi * u[:, 2]
        z[:, 3] = 10 ** (u[:, 3] * 4 - 1)
        return z

    def jax_transform(u):
        return jnp.stack([
            10 ** (u[:, 0] * 4 - 2),
            10 ** (u[:, 1] * 1 - 1.5),
            2 * jnp.pi * u[:, 2],
            10 ** (u[:, 3] * 4 - 1)], axis=1)

    prob = Problem('sine', ['amplitude', 'jitter', 'phase', 'period'],
                   loglike, transform, jax_loglike, jax_transform,
                   logz=None)
    prob.wrapped_params = [False, False, True, False]
    return prob


def slantedeggbox(ndim=2):
    """Eggbox modulated by a laplace peak at 5*pi per axis.

    Reference examples/testslantedeggbox.py: the first two axes carry
    the eggbox modes, every axis adds a slanted |z - 5pi| pull, so the
    mode heights differ and the sampler must rank them.
    """
    import jax.numpy as jnp
    assert ndim >= 2

    def _body(np_, z):
        chi = (2.0 + np_.cos(z[:, 0] / 2) * np_.cos(z[:, 1] / 2)) ** 5
        chi2 = -np_.abs((z - 5 * np.pi) / 0.5).sum(axis=1)
        return chi + chi2

    def loglike(z):
        return _body(np, z)

    def jax_loglike(z):
        return _body(jnp, z)

    def transform(x):
        return x * 100

    def jax_transform(x):
        return x * 100

    return Problem('slantedeggbox%dd' % ndim, _names(ndim), loglike,
                   transform, jax_loglike, jax_transform, logz=None)


def corrpeak(ndim=6, crosssigma=0.005):
    """Mixed-scale gaussian with a non-linear degeneracy and pair ties.

    Reference examples/testcorrpeak.py: per-axis sigmas spanning orders
    of magnitude, a product-degeneracy between the first two axes, and
    tight pairwise correlations between neighbours.
    """
    import jax.numpy as jnp
    assert ndim >= 5
    sigmas = 10 ** (-2.0 + 2.0 * np.cos(np.arange(ndim) - 2))         / (np.arange(ndim) - 2 + 1e-300)
    sigmas[:2] = 1.0
    # the i==2 axis is unconstrained; 1e30 keeps its term at zero in both
    # f32 and f64 without overflowing the jit f32 constant cast
    sigmas = np.minimum(np.abs(sigmas), 1e30)
    centers = np.full(ndim, 0.2)
    degsigma = 0.01

    def _body(np_, theta):
        like = -0.5 * (((theta[:, 1:] - centers[1:])
                        / sigmas[1:])**2).sum(axis=1)
        like = like - 0.5 * ((theta[:, 1] * theta[:, 0]
                              - centers[1] * centers[0]) / degsigma)**2
        a = (theta[:, 3:-1] - centers[3:-1]) / sigmas[3:-1]
        b = (theta[:, 4:] - centers[4:]) / sigmas[4:]
        return like - 0.5 * (((a - b) / crosssigma)**2).sum(axis=1)

    def loglike(theta):
        return _body(np, theta)

    def jax_loglike(theta):
        return _body(jnp, theta)

    return Problem('corrpeak%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=None)


def hyperrect(ndim=2):
    """Top-hat likelihood growing towards the center: pure plateaus.

    L = -ndim*log(max|theta-0.5|): every likelihood contour is a
    hyperrectangle surface, the hardest case for plateau handling
    (reference examples/testhyperrect.py). logZ is analytically 0... the
    enclosed volume shrinks exactly as the likelihood rises.
    """
    import jax.numpy as jnp

    def loglike(theta):
        delta = np.max(np.abs(theta - 0.5), axis=1)
        return np.minimum(-ndim * np.log(delta * 2 + 1e-15), 100.0)

    def jax_loglike(theta):
        delta = jnp.max(jnp.abs(theta - 0.5), axis=1)
        return jnp.minimum(-ndim * jnp.log(delta * 2 + 1e-15), 100.0)

    # int L dV with L = (2 delta)^-ndim over the unit cube:
    # P(delta < d) = (2d)^ndim, so Z = int_0^1 t^-1 ... diverges at the
    # spike but is capped at exp(100); dominated by the cap region:
    # Z = exp(100)*(2e)^-ndim-ish — not analytic here, leave unchecked
    return Problem('hyperrect%dd' % ndim, _names(ndim), loglike, None,
                   jax_loglike, None, logz=None)


def dirichlet(ndim=8, seed=4, ndata=10, nsamples=400):
    """Histogram deconvolution with a simplex (Dirichlet) prior.

    Reference examples/rundirichlet.py: given noisy measurements, infer
    the fraction of objects per histogram bin; the prior transform maps
    the unit cube to the probability simplex via sorted uniforms.
    """
    import jax.numpy as jnp
    rng = np.random.RandomState(seed)
    values = rng.normal(0, 15, size=ndata)
    widths = rng.uniform(3, 15, size=ndata)
    samples = values[:, None] + widths[:, None] * rng.normal(
        size=(ndata, nsamples))
    bins = np.linspace(-80, 80, ndim + 1)
    binned = np.array([np.histogram(row, bins=bins)[0]
                       for row in samples])

    # the sampled space holds the first ndim-1 simplex coordinates; the
    # last bin fraction is 1 - sum (reconstructed in the likelihood)
    def _full(np_, params):
        last = 1.0 - params.sum(axis=1, keepdims=True)
        return np_.concatenate([params, last], axis=1)

    def loglike(params):
        frac = np.dot(binned, _full(np, params).T) / nsamples + 1e-300
        return np.log(frac).sum(axis=0)

    def jax_loglike(params):
        frac = jnp.dot(jnp.asarray(binned, jnp.float32),
                       _full(jnp, params).T,
                       preferred_element_type=jnp.float32,
                       precision='highest') / nsamples
        return jnp.log(frac + 1e-30).sum(axis=0)

    def transform(u):
        # sorted-uniform gaps: uniform on the simplex
        filled = np.column_stack([np.zeros(len(u)), np.sort(u, axis=1),
                                  np.ones(len(u))])
        return np.diff(filled, axis=1)[:, :-1]

    def jax_transform(u):
        filled = jnp.concatenate([
            jnp.zeros((u.shape[0], 1)), jnp.sort(u, axis=1),
            jnp.ones((u.shape[0], 1))], axis=1)
        return jnp.diff(filled, axis=1)[:, :-1]

    return Problem('dirichlet%dd' % ndim, _names(ndim - 1), loglike,
                   transform, jax_loglike, jax_transform, logz=None)
