"""Generate the notebook forms of the gpax_torch examples.

Writes ``examples_torch/notebooks/<name>.ipynb`` for each script of
examples_torch/ (a markdown cell from its docstring, a code cell with its
body, a ``parameters`` cell and a cell calling ``main``), and the two
written notebooks: ``simple_gp_tutorial.ipynb`` (a fully Bayesian ExactGP
tutorial) and ``contrib/dkl_molecular_active_learning.ipynb`` (viDKL
embeddings and active learning on one-hot descriptors). Their names mirror
the JAX package's examples/notebooks/ one to one.

Every notebook has one code cell tagged ``parameters`` (papermill's
convention) holding ``DEVICE = None`` (the CUDA card; ``"cpu"`` runs it on
the CPU) and its budgets. Cells tagged ``plot`` only draw: they use
matplotlib and hold nothing a later cell reads, so a runner without
matplotlib may leave them out (examples_torch/notebook_runner.py).

The output is plain nbformat-4 JSON with fixed key order, indent and cell
ids, and no execution counts or outputs, so a second run gives the same
bytes. Run from the repository root::

    python examples_torch/make_notebooks.py
"""

import ast
import json
import pathlib
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
OUT = EXAMPLES / "notebooks"

KERNELSPEC = {"display_name": "Python 3", "language": "python", "name": "python3"}


def md(text: str) -> dict:
    return {"cell_type": "markdown", "metadata": {}, "source": textwrap.dedent(text).strip()}


def code(text: str, tag: str = None) -> dict:
    return {"cell_type": "code", "execution_count": None,
            "metadata": {"tags": [tag]} if tag else {}, "outputs": [],
            "source": textwrap.dedent(text).strip()}


def plot(text: str) -> dict:
    return code(text, "plot")


def notebook(cells) -> dict:
    """An nbformat-4.5 notebook of ``cells``, ids numbered in order, each
    source split into lines as Jupyter stores it."""
    out = []
    for i, cell in enumerate(cells):
        cell = {**cell, "id": f"cell-{i:02d}"}
        cell["source"] = cell["source"].splitlines(keepends=True)
        out.append(cell)
    return {"cells": out, "metadata": {"kernelspec": KERNELSPEC}, "nbformat": 4,
            "nbformat_minor": 5}


def to_json(nb: dict) -> str:
    return json.dumps(nb, indent=1, sort_keys=True, ensure_ascii=False) + "\n"


# ------------------------------------------------------------------ scripts

def script_parts(path: pathlib.Path):
    """(docstring, body without the docstring and the ``__main__`` guard,
    whether ``main`` takes ``nuts``): the extraction of the JAX package's
    notebook generator."""
    src = path.read_text()
    tree = ast.parse(src)
    doc = ast.get_docstring(tree) or path.stem
    lines = src.splitlines()

    # strip the module docstring and the __main__ guard
    body_start = tree.body[1].lineno - 1 if (
        tree.body and isinstance(tree.body[0], ast.Expr)
    ) else 0
    guard = next(
        (node.lineno - 1 for node in tree.body
         if isinstance(node, ast.If) and getattr(node.test.left, "id", "") == "__name__"),
        len(lines),
    )
    body = "\n".join(lines[body_start:guard]).strip()
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    takes_nuts = any(a.arg == "nuts" for a in main.args.args)
    return doc, body, takes_nuts


def script_notebook(path: pathlib.Path) -> dict:
    doc, body, takes_nuts = script_parts(path)
    title = path.stem.replace("_", " ")
    params = ('DEVICE = None  # the CUDA card; "cpu" runs the notebook on the CPU'
              + ("\nNUTS = None  # keywords merged into the NUTS fits (see the docstring above)"
                 if takes_nuts else ""))
    call = "main(device=DEVICE, nuts=NUTS)" if takes_nuts else "main(device=DEVICE)"
    return notebook([
        md(f"# {title}\n\n{doc}"),
        {**code(""), "source": body},  # verbatim: dedent would blank whitespace-only lines
        code(params, "parameters"),
        code(f"result = {call}\nprint('done:', result)"),
    ])


def scripts():
    """The example scripts: the modules of examples_torch/ that define
    ``main`` (golden.py, this generator and the runner do not)."""
    return sorted(p for p in EXAMPLES.glob("*.py")
                  if any(isinstance(node, ast.FunctionDef) and node.name == "main"
                         for node in ast.parse(p.read_text()).body))


# ------------------------------------------------------------------ tutorial

TUTORIAL = [
    md(r"""
        # Fully Bayesian Gaussian processes, step by step

        This tutorial walks through GP regression with `gpax_torch` on a toy
        1-D problem: what the model is, how the fully Bayesian treatment
        differs from point-estimate GPs, and how priors over kernel
        hyperparameters shape the posterior.

        A GP places a distribution over functions: any finite set of
        function values is jointly Gaussian with covariance given by a
        kernel $k_\theta(x, x')$. Most GP libraries fit the kernel
        hyperparameters $\theta$ by maximizing the marginal likelihood and
        then condition on that single point estimate. Here instead we put
        priors on $\theta = (\sigma, l, \epsilon)$ and integrate over the
        posterior $p(\theta \mid X, y)$ with NUTS — so the predictive
        uncertainty reflects hyperparameter uncertainty too, which matters
        most exactly where data is scarce.
        """),
    code("""
        import numpy as np

        import gpax_torch as gpax

        rng_key, rng_key_predict = gpax.utils.get_keys()
        """),
    md("""
        The notebook runs on the CUDA card. The next cell holds what a run
        may change: `DEVICE = "cpu"` runs every step on the CPU instead,
        where each CUDA kernel's plain PyTorch twin does the kernel's work,
        and `NUTS` is the warmup and sampling budget of both fits.
        """),
    code("""
        DEVICE = None  # the CUDA card; "cpu" runs the notebook on the CPU
        NUTS = dict(num_warmup=500, num_samples=500)
        """, "parameters"),
    plot("import matplotlib.pyplot as plt"),
    md("""
        ## Data

        Noisy observations of a function with both smooth and localized
        structure — a classic trap for a single lengthscale estimate:
        """),
    code("""
        np.random.seed(0)
        NUM_INIT_POINTS = 25
        NOISE_LEVEL = 0.1

        def f(x):
            return 2.0 * np.sin(3.0 * x) + 0.5 * x + 1.5 * np.exp(-12.0 * (x - 0.4) ** 2)

        X = np.random.uniform(-1.0, 1.0, NUM_INIT_POINTS)
        y = f(X) + np.random.normal(0.0, NOISE_LEVEL, NUM_INIT_POINTS)

        X_test = np.linspace(-1, 1, 100)
        """),
    plot("""
        plt.scatter(X, y, marker='x', c='k')
        plt.plot(X_test, f(X_test), lw=0.8, c='gray')
        plt.xlabel('$x$'); plt.ylabel('$y$');
        """),
    md(r"""
        ## Fit an ExactGP with NUTS

        `ExactGP(input_dim, kernel)` with the RBF kernel. `fit` runs the
        No-U-Turn Sampler over the kernel scale, lengthscale, and noise.
        The sampler's tree is driven from Python; each leapfrog step's
        likelihood and gradient run on the card: the gram from a fused CUDA
        kernel, its Cholesky factor in float64 and the factor's inverse from
        a second CUDA kernel. The summary table reports posterior moments
        and the split-$\hat R$ convergence diagnostic for every
        hyperparameter.
        """),
    code("""
        gp_model = gpax.ExactGP(1, 'RBF')
        gp_model.fit(rng_key, X, y, progress_bar=False, device=DEVICE, **NUTS)
        """),
    md(r"""
        ## Predict

        `predict` returns the posterior-mean curve and sampled predictive
        functions — one per posterior draw of $\theta$ (times `n` draws of
        the function given $\theta$). The spread of those curves IS the
        model's honest uncertainty. Its outputs are tensors on the model's
        device; `.cpu().numpy()` brings them to the host.
        """),
    code("""
        y_pred, y_sampled = gp_model.predict(rng_key_predict, X_test, n=1, device=DEVICE)
        y_pred = y_pred.cpu().numpy()
        curves = y_sampled.cpu().numpy().reshape(-1, len(X_test))
        print('posterior mean shape:', y_pred.shape,
              '| sampled curves:', curves.shape)
        """),
    plot("""
        _, ax = plt.subplots(dpi=100)
        ax.scatter(X, y, marker='x', c='k', zorder=2, label='observations')
        for c in curves[::10]:
            ax.plot(X_test, c, c='crimson', alpha=0.1, lw=0.8)
        ax.plot(X_test, y_pred, c='navy', lw=1.5, label='posterior mean')
        ax.plot(X_test, f(X_test), c='gray', lw=0.8, ls='--', label='truth')
        ax.legend(); ax.set_xlabel('$x$'); ax.set_ylabel('$y$');
        """),
    plot(r"""
        sd = curves.std(0)
        _, ax = plt.subplots(dpi=100)
        ax.scatter(X, y, marker='x', c='k', zorder=2)
        ax.plot(X_test, y_pred, c='navy', lw=1.5)
        ax.fill_between(X_test, y_pred - 2 * sd, y_pred + 2 * sd,
                        color='navy', alpha=0.2, label='$2\\sigma$ band')
        ax.legend(); ax.set_xlabel('$x$'); ax.set_ylabel('$y$');
        """),
    md("""
        ## Custom hyperparameter priors

        The default $LogNormal(0, 1)$ lengthscale prior is permissive: it
        admits very long lengthscales, which show up above as a family of
        nearly-linear sampled curves. Domain knowledge about how fast the
        function varies belongs in the prior. `gpax.utils.gamma_dist(c, r)`
        builds a Gamma prior (mean $c/r$); `dviz` plots it:
        """),
    code("lengthscale_prior_dist = gpax.utils.gamma_dist(2, 5)"),
    plot("gpax.utils.dviz(lengthscale_prior_dist, samples=2000)"),
    code("""
        rng_key, rng_key_predict = gpax.utils.get_keys()
        gp_model2 = gpax.ExactGP(1, 'RBF',
                                 lengthscale_prior_dist=lengthscale_prior_dist)
        gp_model2.fit(rng_key, X, y, progress_bar=False, device=DEVICE, **NUTS)
        y_pred2, y_sampled2 = gp_model2.predict(rng_key_predict, X_test, n=1, device=DEVICE)
        curves2 = y_sampled2.cpu().numpy().reshape(-1, len(X_test))
        """),
    plot("""
        _, ax = plt.subplots(dpi=100)
        ax.scatter(X, y, marker='x', c='k', zorder=2)
        for c in curves2[::10]:
            ax.plot(X_test, c, c='crimson', alpha=0.1, lw=0.8)
        ax.plot(X_test, y_pred2.cpu().numpy(), c='navy', lw=1.5)
        ax.set_title('Gamma(2, 5) lengthscale prior')
        ax.set_xlabel('$x$'); ax.set_ylabel('$y$');
        """),
    md("""
        With the informative prior the long-lengthscale (quasi-linear)
        explanations lose posterior mass and the fit tracks local structure
        more closely. The same `*_prior_dist` hook exists for the noise
        (`noise_prior_dist`) — useful when the measurement error is known.

        ## Notes for runs on the card

        * Every entry point (`fit`, `predict`, ...) runs on the CUDA card
          unless `device=` says otherwise, and without a card it raises
          rather than fall back to the CPU. Inputs of any kind (numpy arrays,
          tensors on any device) are moved to the model's device.
        * Each leapfrog step builds the gram with a fused CUDA kernel at
          full float32 precision, factors it in float64 and inverts the
          factor with a CUDA kernel on 128-row tiles, in float64 as well;
          `predict` factors once per posterior draw the same way.
        * The sampler's tree is driven from the host, so at a few dozen
          points a leapfrog step costs milliseconds of host time, whatever
          the data size: 5.5-7.7 ms in this notebook's fits at 100 + 100
          draws on an NVIDIA H100 80GB HBM3 at 700 W (the notebooks phase
          of `chip_smoke.py`). A fit costs its leapfrog count times that;
          `segment_size=` runs a long fit in segments, and `deadline=`
          bounds its wall time.
        """),
    code("""
        summary = {k: float(v.cpu().numpy().mean())
                   for k, v in gp_model2.get_samples().items()}
        rmse = float(np.sqrt(np.mean((y_pred2.cpu().numpy() - f(X_test)) ** 2)))
        print('posterior means:', summary)
        print('rmse vs truth:', round(rmse, 4))
        assert rmse < 0.5
        print('done')
        """),
]


# ------------------------------------------------------------------ contrib

CONTRIB = [
    md("""
        # DKL on molecular-style descriptors: embeddings + active learning

        Deep Kernel Learning (DKL) composes a neural feature extractor with
        a GP: the network learns a low-dimensional embedding in which the
        GP's kernel is a good similarity measure, and the GP supplies
        calibrated uncertainty on top. That combination is what makes DKL a
        practical engine for molecular discovery loops — high-dimensional
        one-hot string descriptors in, uncertainty-aware property
        predictions out.

        The upstream version of this workflow runs on a QM9 subset
        (SMILES → SELFIES → one-hot). This notebook is self-contained: it
        generates a synthetic analog — random 'token sequences' one-hot
        encoded the same way, with a property that depends nonlinearly on a
        few latent sequence motifs — so the full pipeline (embed → predict
        → active learning) runs anywhere with zero downloads.
        """),
    code("""
        import numpy as np

        import gpax_torch as gpax

        np.random.seed(0)
        """),
    md("""
        The notebook runs on the CUDA card. The next cell holds what a run
        may change: `DEVICE = "cpu"` runs every step on the CPU instead,
        where each CUDA kernel's plain PyTorch twin does the kernel's work;
        the SVI steps of the first fit and of each active-learning refit,
        and the number of active-learning steps.
        """),
    code("""
        DEVICE = None  # the CUDA card; "cpu" runs the notebook on the CPU
        FIT_STEPS = 400
        AL_STEPS = 15
        AL_FIT_STEPS = 300
        """, "parameters"),
    plot("import matplotlib.pyplot as plt"),
    md("""
        ## Synthetic descriptor dataset

        600 'molecules', each a length-24 sequence over a 12-token
        alphabet, one-hot encoded and flattened (d = 288) — the same shape
        class as a SELFIES one-hot. The target property counts two motifs
        and adds a smooth composition effect:
        """),
    code("""
        N, L, A = 600, 24, 12
        seqs = np.random.randint(0, A, size=(N, L))
        X = np.eye(A, dtype=np.float32)[seqs].reshape(N, L * A)

        def property_fn(s):
            motif1 = np.mean((s[:, :-1] == 3) & (s[:, 1:] == 7), axis=1)
            motif2 = np.mean(s == 11, axis=1)
            comp = np.sin(4.0 * s.mean(axis=1) / A)
            return 10.0 * motif1 - 4.0 * motif2 + comp

        y = property_fn(seqs) + 0.05 * np.random.randn(N)
        y = (y - y.mean()) / y.std()
        print('X:', X.shape, ' y:', y.shape)
        """),
    md("""
        ## Train a viDKL model and look at its latent space

        `viDKL` trains the MLP weights and GP hyperparameters jointly by
        stochastic variational inference. `embed` exposes the learned
        2-D latent space:
        """),
    code("""
        rng_key, rng_key_predict = gpax.utils.get_keys()
        n_train = 150
        idx = np.random.choice(N, n_train, replace=False)

        dkl = gpax.viDKL(input_dim=X.shape[-1], z_dim=2, kernel='RBF')
        dkl.fit(rng_key, X[idx], y[idx], num_steps=FIT_STEPS,
                print_summary=False, progress_bar=False, device=DEVICE)
        z_all = dkl.embed(X, device=DEVICE).cpu().numpy()
        pred_mean, pred_var = dkl.predict_in_batches(rng_key_predict, X,
                                                     batch_size=250, device=DEVICE)
        """),
    plot("""
        fig, ax = plt.subplots(1, 2, figsize=(9, 3.5), dpi=100)
        s0 = ax[0].scatter(z_all[:, 0], z_all[:, 1], c=y, s=8, cmap='viridis')
        ax[0].set_title('latent space, colored by true property')
        plt.colorbar(s0, ax=ax[0])
        ax[1].errorbar(y, pred_mean.cpu().numpy(),
                       yerr=2 * np.sqrt(pred_var.cpu().numpy()),
                       fmt='.', ms=3, alpha=0.4, elinewidth=0.5)
        ax[1].plot([-3, 3], [-3, 3], c='k', lw=0.8)
        ax[1].set_xlabel('true'); ax[1].set_ylabel('predicted')
        plt.tight_layout()
        """),
    md("""
        ## Active learning

        Start from a small seed set and let the model choose what to
        'measure' next with the UCB acquisition over its own predictive
        uncertainty — the loop that matters when each measurement is an
        expensive experiment. Each iteration refits from scratch and
        acquires the highest-UCB unmeasured candidate. The SVI loop runs
        from Python, one Adam step at a time; each step's GP term builds
        its gram with a fused CUDA kernel and inverts the float64 factor
        with a second one, so a step costs milliseconds of host time:
        6.7-7.9 ms in this notebook's fits on an NVIDIA H100 80GB HBM3 at
        700 W (the notebooks phase of `chip_smoke.py`).
        """),
    code("""
        init_num, steps = 30, AL_STEPS
        measured = list(np.random.choice(N, init_num, replace=False))
        rmse_trace = []
        for step in range(steps):
            pool = np.setdiff1d(np.arange(N), measured)
            key_fit, key_acq = gpax.utils.get_keys(step)
            model = gpax.viDKL(input_dim=X.shape[-1], z_dim=2, kernel='RBF')
            model.fit(key_fit, X[measured], y[measured], num_steps=AL_FIT_STEPS,
                      print_summary=False, progress_bar=False, device=DEVICE)
            mean, var = model.predict_in_batches(key_acq, X[pool],
                                                 batch_size=250, device=DEVICE)
            ucb = mean.cpu().numpy() + 2.0 * np.sqrt(var.cpu().numpy())
            measured.append(int(pool[np.argmax(ucb)]))
            full_mean, _ = model.predict_in_batches(key_acq, X,
                                                    batch_size=250, device=DEVICE)
            rmse_trace.append(float(np.sqrt(np.mean(
                (full_mean.cpu().numpy() - y) ** 2))))
        print('pool rmse per AL step:', [round(r, 3) for r in rmse_trace])
        """),
    plot("""
        plt.figure(dpi=100)
        plt.plot(rmse_trace, marker='o')
        plt.xlabel('active-learning step'); plt.ylabel('pool RMSE')
        """),
    code("""
        best = np.argsort(-y)[:10]
        found = len(set(best) & set(measured))
        print(f'top-10 property candidates already measured: {found}/10')
        assert rmse_trace[-1] < 1.0
        print('done')
        """),
]


def notebooks() -> dict:
    """{path relative to the notebooks directory: notebook}."""
    out = {f"{p.stem}.ipynb": script_notebook(p) for p in scripts()}
    out["simple_gp_tutorial.ipynb"] = notebook(TUTORIAL)
    out["contrib/dkl_molecular_active_learning.ipynb"] = notebook(CONTRIB)
    return out


def write_all(out_dir: pathlib.Path = OUT) -> list:
    """Write every notebook under ``out_dir``; returns their paths."""
    paths = []
    for rel, nb in notebooks().items():
        path = pathlib.Path(out_dir) / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(to_json(nb), encoding="utf-8")
        paths.append(path)
    return paths


if __name__ == "__main__":
    for path in write_all():
        print("wrote", path.relative_to(ROOT))
